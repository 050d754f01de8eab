#!/usr/bin/env python3
"""Length of each Monte-Carlo kernel's step loop in the compiled SASS, to
hold the operation counts of the roofline bounds against the machine code.

    python3 scripts/sass_step_loops.py [--out DIR]

Builds the hand-written kernels of ``stochvolmodels_torch/csrc`` (as
``chip_smoke.py`` does), disassembles each library with ``cuobjdump -sass``
and, for every kernel function, takes the longest backward branch as the
step loop: it prints the number of instructions inside it and the most
frequent opcodes.  The loop holds the branched-over slow paths of sqrt and
division, and a loop the compiler unrolled holds several steps.  The full
disassembly goes to ``<out>/sass_<kernel>.txt``.  Needs the CUDA toolkit
(nvcc and cuobjdump), not a GPU.
"""
import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants")


def functions(sass: str) -> dict:
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


def step_loop(instrs) -> collections.Counter:
    """opcode counts of the instructions inside the longest backward branch."""
    loops = [(addr - int(m.group(1), 16), int(m.group(1), 16), addr) for addr, text in instrs
             for m in [re.search(r"BRA (0x[0-9a-f]+)", text)] if m and int(m.group(1), 16) < addr]
    if not loops:
        return collections.Counter()
    _, lo, hi = max(loops)
    ops = collections.Counter()
    for addr, text in instrs:
        if lo <= addr <= hi:
            ops[re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]] += 1
    return ops


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=Path("chiprun_out/sass"))
    args = parser.parse_args()
    from stochvolmodels_torch.ops import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    _build.load_libraries(KERNELS)
    args.out.mkdir(parents=True, exist_ok=True)
    for kernel in KERNELS:
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(kernel))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        (args.out / f"sass_{kernel}.txt").write_text(sass)
        for name, instrs in sorted(functions(sass).items()):
            ops = step_loop(instrs)
            template = ",".join(re.findall(r"Li(\d+)E", name))
            print(f"{kernel}{'<' + template + '>' if template else ''}: {sum(ops.values())} "
                  f"instructions in the step loop; "
                  + ", ".join(f"{op} {n}" for op, n in ops.most_common(8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
