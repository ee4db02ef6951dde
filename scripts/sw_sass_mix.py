#!/usr/bin/env python3
"""Print the instruction mix of one DP step of each Smith-Waterman kernel
instantiation, from the SASS of the library as the port builds it.

    python3 scripts/sw_sass_mix.py

Builds csrc/smith_waterman.cu (nvcc, the port's flags) if needed, runs
`cuobjdump -sass` on it, and for each `sw_kernel<banded, W>` takes the
first unrolled 16-step block: the span from its first to its sixteenth
`SHFL.UP` (one shuffle a step) is 15 steps. Prints the instructions a step
by opcode, and the share that issues to the integer ALU pipe, whose 16
lanes a scheduler take two cycles for each warp instruction on an H100
(the FMA pipe, which runs IMAD, has 32). Needs the CUDA toolkit, not a
card.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# integer ALU pipe opcodes (the rest: IMAD on the FMA pipe, SHFL, memory,
# branches)
ALU = {"SEL", "ISETP", "LOP3", "SHF", "IADD3", "VIADD", "VIMNMX3", "VIMNMX",
       "IMNMX", "LEA", "PRMT", "PLOP3", "IABS", "BMSK", "FLO", "POPC"}


def step_mix(sass: str):
    """(kernel, instructions a step, ALU instructions a step, Counter of
    opcodes over 15 steps) for each sw_kernel instantiation in `sass`."""
    for body in sass.split("Function : ")[1:]:
        kind = re.search(r"sw_kernelILb([01])ELi(\d+)E", body.split()[0])
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            body)]
        shfl = [i for i, op in enumerate(ops) if op.startswith("SHFL.UP")]
        if not kind or len(shfl) < 16:
            continue
        mix = Counter(op.split(".")[0] for op in ops[shfl[0]:shfl[15]])
        alu = sum(n for op, n in mix.items() if op in ALU)
        label = (f"sw_kernel<{'true' if kind.group(1) == '1' else 'false'}, "
                 f"{kind.group(2)}>")
        yield label, sum(mix.values()) / 15, alu / 15, mix


def main() -> int:
    from genome_assembly_tpu_torch._build import build_shared_library
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    lib = build_shared_library("smith_waterman", sw.SOURCE,
                               [sw._nvcc(), *sw.NVCC_FLAGS],
                               timeout=sw.BUILD_TIMEOUT_S)
    cuobjdump = (shutil.which("cuobjdump")
                 or os.path.join(os.path.dirname(sw._nvcc()), "cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for label, per_step, alu, mix in step_mix(sass):
        print(f"{label}: {per_step:.2f} instructions a step, {alu:.2f} on "
              f"the integer ALU pipe (>= {2 * alu:.1f} cycles a warp-step "
              f"a scheduler); by opcode a step: " + ", ".join(
                  f"{op} {n / 15:.2f}" for op, n in mix.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
