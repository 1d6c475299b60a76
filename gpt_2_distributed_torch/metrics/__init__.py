"""Metric registry and the CLI metrics tracker
(``gpt_2_distributed_tpu/metrics``)."""
