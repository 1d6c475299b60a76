"""Device selection for the port's entry points.

Every entry point (the serving CLI, ``ServingEngine``, ``generate_cached``)
runs on CUDA unless its caller asks for the CPU. A host without a visible
GPU is an error, never a quiet move to the CPU: a run that was meant to
measure the card must not report CPU numbers under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """``"cuda"`` when ``name`` is None. Raises RuntimeError when a CUDA
    device is asked for (explicitly or by default) and none is visible."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {str(dev)!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return dev
