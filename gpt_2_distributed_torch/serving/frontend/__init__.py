"""The serving front door (``gpt_2_distributed_tpu/serving/frontend``): the
HTTP/SSE server, the replica router, the autoscaler, and the shared
engine-driver both serving entry points run on.

Layering (each importable alone; the server composes all of them)::

    server.py     asyncio HTTP front end (`gpt2-torch-frontend`)
    driver.py     the ONE submit/step/drain loop (also used by serve.py)
    autoscale.py  grow/shrink decisions from queue-depth + SLO signals
    router.py     prefix-affinity routing + SLO-aware admission

Worker processes, their RPC plane and remote hosts come with the
process-isolation slice.
"""

# Lazy exports (PEP 562): importing the package imports no engine (torch)
# until a name is used.
_EXPORTS = {
    "Autoscaler": "autoscale",
    "DrainingError": "driver",
    "EngineDriver": "driver",
    "ROUTE_POLICIES": "router",
    "ReplicaRouter": "router",
    "ShedError": "router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"gpt_2_distributed_torch.serving.frontend.{_EXPORTS[name]}"
        )
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
