"""Count the instructions of the K-trial kernels from their SASS.

    python3 -m tpu_lbfgs_torch.bench.sass_count [--csrc DIR]
        [--kernel REGEX] [--out FILE]

Builds the kernels' library (``kernels/_build.py``; ``--csrc`` another
tree of sources, as for ``bench/kernel_ab.py``), disassembles it with
``cuobjdump -sass`` and, for every kernel whose demangled name matches
``--kernel`` (default: the ``multi_phi`` and ``multi_phi_dphi`` stage-1
kernels), splits its code into basic blocks (at labels and after
branches) and prints each block that converts a float32 to float64
(``F2F.F64.F32``): its instruction count and its opcodes.  A block of the
unrolled trial loop holds one trial's terms of a run, so its counts, less
the loop's exit test (an ISETP and a BRA), over the run's elements are
the instructions per element and trial that ``bench/trial_bounds.py``
holds for that kernel function.  ``--out`` writes the matched kernels'
whole SASS to a file.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit), not a card.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

from ..kernels import _build

DEFAULT = r"multi_phi(_dphi)?(_batched)?_kernel"
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _cuobjdump() -> str:
    return str(Path(_build.find_nvcc()).with_name("cuobjdump"))


def functions(lib: Path) -> dict:
    """{demangled kernel name: its SASS lines}."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    names = parts[1::2]
    plain = subprocess.run(["c++filt", *names], capture_output=True,
                           text=True, check=True).stdout.split("\n")
    return {p: body.split("\n") for p, body in zip(plain, parts[2::2])}


def blocks(lines) -> list:
    """The basic blocks of one kernel, each a list of opcodes."""
    out, cur = [], []
    for line in lines:
        if re.match(r"\s*\.L_x_\d+:", line) and cur:
            out.append(cur)
            cur = []
        m = _INSN.search(line)
        if m is None:
            continue
        cur.append(m.group(1))
        if m.group(1).split(".")[0] in ("BRA", "EXIT", "RET", "BRX", "JMP"):
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="sass_count")
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--kernel", default=DEFAULT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    csrc = Path(args.csrc).resolve() if args.csrc else _build.CSRC
    lib = _build.build(csrc)[0]
    kept = {k: v for k, v in functions(lib).items()
            if re.search(args.kernel, k)}
    if args.out:
        Path(args.out).write_text("".join(
            f"Function : {k}\n" + "\n".join(v) + "\n" for k, v in kept.items()))
    for name, lines in kept.items():
        bbs = blocks(lines)
        total = sum(map(len, bbs))
        print(f"== {name}: {total} instructions, {len(bbs)} blocks")
        for i, bb in enumerate(bbs):
            hist = collections.Counter(bb)
            if not hist["F2F.F64.F32"]:
                continue
            ops = ", ".join(f"{op} {c}" for op, c in sorted(hist.items()))
            print(f"  block {i}: {len(bb)} instructions, "
                  f"{hist['F2F.F64.F32']} conversions: {ops}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
