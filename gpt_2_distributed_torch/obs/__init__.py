"""Observability: span-based structured tracing (`obs.trace`).

Metrics (windows -> TensorBoard/CLI) live in
`gpt_2_distributed_torch.metrics`; this package answers where inside a step
the host's time went and what one serving request lived through. The trace
files are the JAX package's schema, so `scripts/obs_report.py` reads both.
"""

from gpt_2_distributed_torch.obs.trace import (
    ProfilerCapture,
    Tracer,
    configure_tracing,
    get_tracer,
    parse_profile_at,
)

__all__ = ["ProfilerCapture", "Tracer", "configure_tracing", "get_tracer",
           "parse_profile_at"]
