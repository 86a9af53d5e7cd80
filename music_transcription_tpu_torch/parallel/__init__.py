"""Train and eval steps (one device)."""
