"""Training step and the sequence-parallel mesh
(``gpt_2_distributed_tpu/parallel``); the sharding modules come with the
DDP/FSDP slice."""
