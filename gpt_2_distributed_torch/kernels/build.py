"""Build the port's CUDA kernels and load them with ctypes.

Each source in ``gpt_2_distributed_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
at first use, under ``build/`` at the root of the checkout (listed in
``.gitignore``). A library's file name carries a hash of its source and of
every header in ``csrc/`` (``*.cuh``), so an edited kernel or header is
rebuilt and a stale library is never loaded. Sources that are built
together are compiled by parallel ``nvcc`` processes.

The C entry points take raw device pointers, sizes, strides and the CUDA
stream as plain integers, launch on that stream, and return
``cudaGetLastError()``: :func:`check` turns a nonzero code into an
exception, so a refused launch (too many threads, too much shared memory)
is never mistaken for a result. Nothing here catches a build or launch
error: there is no fallback to a plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    sha = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.name.encode() + header.read_bytes())
    digest = sha.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every missing library among ``names``, one ``nvcc`` per
    source, all started together. Returns each source's ptxas report
    (registers, shared memory, spills); empty for a library already built.
    Raises RuntimeError naming the source when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports = {name: "" for name in names}
    failed = []
    for name, (tmp, out, proc) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"csrc/{name}.cu (nvcc rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` and every ``restype`` an int (the
    ``cudaError_t`` the entry point returns)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
