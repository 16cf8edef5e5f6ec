"""Count K3's instructions a pixel-colour pair in its compiled search loop.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.sass_k3 [LIB] [--dump FILE]

Disassembles the kernels' library (``cuobjdump -sass``; by default the
library that ``ops/cuda/build.py`` builds from this checkout, built if
missing) and, for each instantiation of ``palette_dither_kernel``, finds the
loop with the most ``IDP4A`` (one a pair in the integer-key design; a loop is
the instructions from a label to the backward branch that returns to it).
Prints one JSON line an instantiation: the loop's instructions, its IDP4A,
instructions a pair (the two divided) and the count by opcode; ``--dump``
writes the kernel's whole listing to FILE. Needs the CUDA toolkit
(``cuobjdump``), not a card.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
TARGET = re.compile(r"0x([0-9a-f]+)")
FUNC = re.compile(r"Function : (\S+)")


def loops(listing: str):
    """The instructions (opcodes) of each loop: from a backward branch's
    target address to the branch."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in INSTR.finditer(listing)]
    out = []
    for addr, op, rest in ins:
        t = TARGET.search(rest) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) <= addr:
            out.append([o for a, o, _ in ins if int(t.group(1), 16) <= a <= addr])
    return out


def count(sass: str) -> list:
    """For each palette_dither_kernel: its search loop, the loop that reads
    the shared palette (LDS) with the most IDP.4A (one a pair)."""
    recs = []
    for block in re.split(r"(?=\s+Function : )", sass):
        f = FUNC.search(block)
        if not f or "palette_dither_kernel" not in f.group(1):
            continue
        search = [lp for lp in loops(block) if any(op.startswith("LDS") for op in lp)]
        best = max(search, default=None, key=lambda ops: sum(op.startswith("IDP") for op in ops))
        if best is None:
            continue
        pairs = sum(op.startswith("IDP") for op in best)
        recs.append(dict(function=f.group(1), loop_instructions=len(best), pairs=pairs,
                         instructions_per_pair=len(best) / pairs if pairs else None,
                         opcodes=dict(collections.Counter(op.split(".")[0] for op in best))))
    return recs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dump = None
    if "--dump" in argv:
        i = argv.index("--dump")
        dump = argv[i + 1]
        del argv[i:i + 2]
    if argv:
        lib = argv[0]
    else:
        from ..ops.cuda import build

        lib = build.library_path()
        if not os.path.exists(lib):
            build.build(lib)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    recs = count(sass)
    if dump:
        with open(dump, "w") as f:
            f.write("".join(b for b in re.split(r"(?=\s+Function : )", sass)
                            if "palette_dither_kernel" in b))
    print(json.dumps({"functions": len(FUNC.findall(sass)), "listing_bytes": len(sass)}))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return 0 if recs else 1


if __name__ == "__main__":
    sys.exit(main())
