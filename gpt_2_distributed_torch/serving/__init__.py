"""Serving: the paged KV cache, the continuous-batching engine, the CLI."""

# Lazy exports (PEP 562): the engine imports torch, but the worker RPC
# plane (``frontend/rpc.py``, the frontend side of ``frontend/worker.py``)
# must import without it: the worker binds its socket before the torch
# import, and the CLIs validate placement flags before paying for it.
_EXPORTS = {
    "BlockAllocator": "paged_cache",
    "PrefixCache": "paged_cache",
    "RequestHandle": "engine",
    "ServingEngine": "engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f"gpt_2_distributed_torch.serving.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
