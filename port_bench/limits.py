"""
The readings that a cell's limits are set from, in one process: the
program's first request on each of ``--seeds`` seeds against the plain
reference (the lower readings), and each control of the entry (its
``CONTROLS``: the reference with one of the configuration's precisions a
step below) against the reference on ``--control-seeds`` seeds (the upper
readings, a control each).  Everything runs at the
cell's own sizes; the benchmark's runs never run this.

    python3 port_bench/limits.py --workload <cell> [--seeds 12] [--control-seeds 3]
        [--first-seed 1000003] [--out <file.json>]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _path in (BENCH_DIR.parent, BENCH_DIR):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

from bench_lib import cells, guard  # noqa: E402


def readings(workload: str, seeds, control_seeds, device=None, overrides=None) -> dict:
    import torch

    import run

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("limits: no CUDA card")
        device = "cuda"
    device = torch.device(device)
    cell = cells.resolve(workload)
    overrides = overrides or {}
    config = run._merge(cell.config, overrides.get("config"))
    traffic = run._merge(cell.traffic, overrides.get("traffic"))
    module = cell.entry()
    entry = module.Entry(cell, seeds[0], device, config, traffic)
    entry.setup()
    rows = []
    for i, s in enumerate(seeds):
        entry.seed = int(s)
        inputs = entry.make(0)
        t0 = time.perf_counter()
        out = entry.call(inputs)
        t1 = time.perf_counter()
        ref = entry.reference(inputs)
        t2 = time.perf_counter()
        row = dict(seed=int(s), kind="program", program_s=t1 - t0, reference_s=t2 - t1,
                   **entry.gaps(out, ref))
        rows.append(row)
        print(json.dumps(row), flush=True)
        for control in module.CONTROLS if i < control_seeds else ():
            t3 = time.perf_counter()
            ctrl = entry.reference(inputs, control=control)
            row_c = dict(seed=int(s), kind=control, control_s=time.perf_counter() - t3,
                         **entry.gaps(ctrl, ref))
            rows.append(row_c)
            print(json.dumps(row_c), flush=True)
    names = [k for k in rows[0] if k not in ("seed", "kind", "program_s", "reference_s")]
    summary = {n: dict(lower=max(r[n] for r in rows if r["kind"] == "program"),
                       upper={c: min((r[n] for r in rows if r["kind"] == c), default=None)
                              for c in module.CONTROLS})
               for n in names}
    return dict(workload=workload, device=str(device), rows=rows, summary=summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000003)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    guard.pin_caches(BENCH_DIR.parent)
    seeds = [args.first_seed + 7717 * i for i in range(args.seeds)]
    res = readings(args.workload, seeds, args.control_seeds)
    print(json.dumps(res["summary"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
