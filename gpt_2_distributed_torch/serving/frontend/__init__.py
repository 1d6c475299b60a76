"""The serving front door (``gpt_2_distributed_tpu/serving/frontend``): the
HTTP/SSE server, the replica router, the autoscaler, and the shared
engine-driver both serving entry points run on.

Layering (each importable alone; the server composes all of them)::

    server.py     asyncio HTTP front end (`gpt2-torch-frontend`)
    driver.py     the ONE submit/step/drain loop (also used by serve.py)
    autoscale.py  grow/shrink decisions from queue-depth + SLO signals
    router.py     prefix-affinity routing + SLO-aware admission
    worker.py     process placement (WorkerHandle/WorkerSpawner/RemoteSpawner)
    rpc.py        length-prefixed JSON framing for the worker RPC plane
    netchaos.py   the in-path TCP proxy that breaks links on cue
"""

# Lazy exports (PEP 562): importing the package imports no engine (torch)
# until a name is used; rpc, netchaos and worker stay torch-free, so the
# worker CLI binds its socket before the torch import and the CLIs check
# their flags before paying for it.
_EXPORTS = {
    "Autoscaler": "autoscale",
    "DrainingError": "driver",
    "EngineDriver": "driver",
    "StepWatchdog": "driver",
    "ROUTE_POLICIES": "router",
    "ReplicaRouter": "router",
    "ShedError": "router",
    "WireError": "rpc",
    "ChaosProxy": "netchaos",
    "RemoteSpawner": "worker",
    "WorkerHandle": "worker",
    "WorkerSpawner": "worker",
    "read_worker_pool": "worker",
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
