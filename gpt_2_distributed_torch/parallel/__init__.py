"""Training step, mesh and placement rules (``gpt_2_distributed_tpu/parallel``):
one device, or a data / fsdp / sequence-parallel mesh of processes."""
