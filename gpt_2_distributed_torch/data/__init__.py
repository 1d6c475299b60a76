"""Token-shard data pipeline (``gpt_2_distributed_tpu/data``)."""
