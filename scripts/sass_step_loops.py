#!/usr/bin/env python3
"""Length of each Monte-Carlo kernel's step loop in the compiled SASS, to
hold the operation counts of the roofline bounds against the machine code.

    python3 scripts/sass_step_loops.py [--out DIR]

Builds the hand-written kernels of ``stochvolmodels_torch/csrc`` (as
``chip_smoke.py`` does), disassembles each library with ``cuobjdump -sass``
and, for every kernel function, takes the longest backward branch as the
step loop: it prints the number of instructions inside it, the number on
its common path, and the most frequent opcodes.  The loop holds the
branched-over slow paths of sqrt and division and the kernels' rare branches
(the Hawkes kernel's logarithms and jump sizes, the key ring's refill); the
common path walks the loop taking every forward branch inside it, so it
skips those bodies.  A loop the compiler unrolled holds several steps.  The
full disassembly goes to ``<out>/sass_<kernel>.txt``.  Needs the CUDA
toolkit (nvcc and cuobjdump), not a GPU.
"""
import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants")
CSRC = Path(__file__).resolve().parents[1] / "stochvolmodels_torch" / "csrc"


def steps_per_pass(kernel: str, csrc: Path = CSRC) -> int:
    """model steps in one pass of a kernel's step loop: the ``kStepsPerPass``
    that ``<csrc>/<kernel>.cu`` unrolls its loop by, 1 where it has none."""
    m = re.search(r"constexpr int kStepsPerPass = (\d+);", (csrc / f"{kernel}.cu").read_text())
    return int(m.group(1)) if m else 1


def functions(sass: str) -> Dict[str, List[Tuple[int, str]]]:
    """{function name: [(address, instruction text)]} of a cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _branch_target(text: str):
    m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def step_loop(instrs) -> Tuple[collections.Counter, int]:
    """(opcode counts of the instructions inside the longest backward branch,
    the number of instructions on its common path: from the loop's head to
    its back edge, taking every forward branch whose target lies inside the
    loop, following no instruction twice)."""
    loops = [(addr - target, target, addr) for addr, text in instrs
             for target in [_branch_target(text)] if target is not None and target < addr]
    if not loops:
        return collections.Counter(), 0
    _, lo, hi = max(loops)
    body = [(addr, text) for addr, text in instrs if lo <= addr <= hi]
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
                              for _, text in body)
    at = {addr: i for i, (addr, _) in enumerate(body)}
    common, i, seen = 0, 0, set()
    while i < len(body) and i not in seen:
        seen.add(i)
        addr, text = body[i]
        common += 1
        target = _branch_target(text)
        if addr == hi:
            break
        if target is not None and addr < target <= hi and target in at:
            i = at[target]
        elif target is not None and not text.startswith("@"):
            break  # an unconditional branch out of the loop or back inside it
        else:
            i += 1
    return ops, common


def disassemble(lib_path: Path) -> str:
    from stochvolmodels_torch.ops import _build
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def loop_lengths(sass: str) -> Dict[str, Tuple[int, int, collections.Counter]]:
    """{kernel instance: (instructions in the step loop, on its common path,
    opcode counts)} of one library's SASS; an instance is named by its
    template arguments ("" for a plain kernel)."""
    out = {}
    for name, instrs in sorted(functions(sass).items()):
        ops, common = step_loop(instrs)
        out[",".join(re.findall(r"Li(\d+)E", name))] = (sum(ops.values()), common, ops)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=Path("chiprun_out/sass"))
    args = parser.parse_args()
    from stochvolmodels_torch.ops import _build

    _build.load_libraries(KERNELS)
    args.out.mkdir(parents=True, exist_ok=True)
    for kernel in KERNELS:
        sass = disassemble(_build._lib_path(kernel))
        (args.out / f"sass_{kernel}.txt").write_text(sass)
        for template, (total, common, ops) in loop_lengths(sass).items():
            print(f"{kernel}{'<' + template + '>' if template else ''}: {total} "
                  f"instructions in the step loop, {common} on its common path; "
                  + ", ".join(f"{op} {n}" for op, n in ops.most_common(8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
