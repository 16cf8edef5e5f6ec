"""Write ``csrc/wgmma_ops.cuh``: one overload of ``wgmma_bf16`` a width N for
``wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16`` with A and B by
shared-memory descriptor, into N / 2 fp32 registers a thread, adding to them
or (scale_d = 0) overwriting them.

An inline asm statement names every output register, so each N needs its own
operand list; this script writes them out for the widths K4 is compiled at
(``lane_packing.WIDTHS``).

    python -m fs_uae_image_enhancer_project_tpu_torch.ops.cuda.gen_wgmma

``tests/test_torch_lane_packing.py`` checks that the committed header is
what this script writes.
"""
from __future__ import annotations

import os

from .lane_packing import WIDTHS as K4_WIDTHS

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "wgmma_ops.cuh")
WIDTHS = tuple(sorted(K4_WIDTHS))


def function(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (
        f"// m64n{n}k16\n"
        f"__device__ __forceinline__ void wgmma_bf16(float (&d)[{r}], uint64_t da, uint64_t db,\n"
        f"                                           int scale_d) {{\n"
        f"  asm volatile(\n"
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'      "{{{regs}}}, "\n'
        f'      "%{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
        f"      : {outs}\n"
        f'      : "l"(da), "l"(db), "r"(scale_d));\n'
        f"}}\n")


def render() -> str:
    head = ("// Generated by ops/cuda/gen_wgmma.py; do not edit by hand.\n"
            "//\n"
            "// wgmma_bf16(d, da, db, scale_d), overloaded on the size of d:\n"
            "// d = A (64 x 16, descriptor da) x B (16 x N, descriptor db) + (scale_d ? d : 0),\n"
            "// N = 2 x size of d, bf16 in, fp32 accumulators, both operands K-major in\n"
            "// shared memory, d in the m64nNk16 accumulator layout.\n"
            "#pragma once\n\n#include <stdint.h>\n\n")
    return head + "\n".join(function(n) for n in WIDTHS)


def main() -> None:
    with open(HEADER, "w") as f:
        f.write(render())


if __name__ == "__main__":
    main()
