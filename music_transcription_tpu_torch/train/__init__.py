"""Training: optimizer, loop, watchdog and the training CLI."""
