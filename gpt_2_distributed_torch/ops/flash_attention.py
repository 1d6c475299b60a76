"""Causal flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu``,
its plain PyTorch version, and their wrapper.

Counterpart of ``gpt_2_distributed_tpu/ops/flash_attention.py`` (the
forward of its Pallas kernel, without dropout). The kernel runs on CUDA
tensors only; a CPU tensor goes to the plain version, and a CUDA tensor
launches the kernel or raises — there is no fallback from a failed build
or launch to the plain version. The plain version is the dense prefill
attention of ``ops/attention.py`` (its ``o`` bit for bit), plus the lse.

``flash_attention_fwd.launches`` counts kernel launches (never plain
calls), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.ops.attention import causal_attention_bthd, causal_scores

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (32, 64, 128)

_SIGNATURES = {
    "flash_fwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                    # o, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H T D
        ctypes.c_void_p,                                     # int64 strides[12]
        ctypes.c_void_p,                                     # stream
    ],
}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense causal attention over ``[B, H, T, D]``: fp32 scores and
    softmax, probabilities cast to q's dtype before the product with V
    (``ops/attention.py::causal_attention``, bit for bit).

    Returns ``(o, lse)``: ``o`` in q's dtype and ``lse`` the fp32 base-2
    log-sum-exp of each row's scaled scores, ``[B, H, T]`` — the same pair
    the kernel writes. fp32 inputs give the fp32 reference the kernel is
    held against."""
    scores = causal_scores(q, k)
    lse = torch.logsumexp(scores, dim=-1)
    o = torch.softmax(scores, dim=-1).to(q.dtype) @ v
    return o, lse * LOG2E


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel: {name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash kernel: {name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash kernel: {name} needs a unit stride on its last dim")


def _launch_kernel(q, k, v, o):
    """Launch the kernel on [B, H, T, D] views (any b/h/t strides)."""
    b, h, t, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        _check_operand(name, x, (b, h, t, d))
        if x.device != q.device:
            raise ValueError(f"flash kernel: {name} on {x.device}, q on {q.device}")
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = torch.tensor(
        [s for x in (q, k, v, o) for s in x.stride()[:3]], dtype=torch.int64
    )
    lib = build.load("flash_fwd", _SIGNATURES)
    code = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, t, d, strides.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_fwd_bf16")
    flash_attention_fwd.launches += 1
    return lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal attention over ``[B, H, T, D]``; returns ``(o, lse)`` with
    ``lse`` fp32 base-2 ``[B, H, T]``. CUDA tensors launch the kernel (bf16,
    D in 32/64/128, any T); CPU tensors use the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = _launch_kernel(q, k, v, o)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D]`` entry point (the model's layout); returns o only.

    The kernel reads and writes through strides, so the head-major views
    cost no copy. CPU tensors use the dense plain version."""
    if not q.is_cuda:
        return causal_attention_bthd(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_kernel(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   o.transpose(1, 2))
    return o
