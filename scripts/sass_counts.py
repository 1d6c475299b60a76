"""Instruction counts of the port's kernels from their SASS, on a machine
with the CUDA toolkit (``nvcc`` and ``cuobjdump``).

    python scripts/sass_counts.py fused_layer bias_gelu

Builds ``gpt_2_distributed_torch/csrc/<source>.cu`` with ``kernels/build.py``
(as at first use), disassembles the library with ``cuobjdump -sass``, and
prints, for each kernel whose name holds the given piece, its instruction
count, the count of each loop body (the instructions between a backward
branch and its target, every path of the body included) and the body's
``MUFU`` (transcendental) instructions and ``CALL``s (slow-path routines).
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from gpt_2_distributed_torch.kernels import build  # noqa: E402

INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def opcode(text: str) -> str:
    words = text.split()
    return (words[1] if words[0].startswith("@") else words[0]).split(".")[0]


def main() -> None:
    source, piece = sys.argv[1:3]
    build.build([source])
    sass = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"), "-sass",
                           str(build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    for section in re.split(r"\n\s*Function : ", sass)[1:]:
        name = section.split("\n", 1)[0].strip()
        if piece not in name:
            continue
        body = [(int(a, 16), t) for a, t in INSTRUCTION.findall(section)]
        print(f"{name}: {len(body)} instructions", flush=True)
        for addr, text in body:
            target = re.search(r"BRA\s+.*?0x([0-9a-f]+)", text)
            if target and int(target.group(1), 16) < addr:
                loop = [opcode(t) for a, t in body if int(target.group(1), 16) <= a <= addr]
                print(f"  loop at {target.group(1)}: {len(loop)} instructions, "
                      f"{loop.count('MUFU')} MUFU, {loop.count('CALL')} CALL", flush=True)


if __name__ == "__main__":
    main()
