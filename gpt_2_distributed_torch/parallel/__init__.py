"""Training step (``gpt_2_distributed_tpu/parallel``); the mesh and
sharding modules come with the DDP/FSDP slice."""
