"""Train and eval steps, on one device or data-parallel across processes:
the processes (``distributed``), their data axis (``mesh``) and sharded
train state (``partitioning``)."""
