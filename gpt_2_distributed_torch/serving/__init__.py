"""Serving: the paged KV cache, the continuous-batching engine, the CLI."""

from gpt_2_distributed_torch.serving.engine import RequestHandle, ServingEngine
from gpt_2_distributed_torch.serving.paged_cache import BlockAllocator

__all__ = ["BlockAllocator", "RequestHandle", "ServingEngine"]
