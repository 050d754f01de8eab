#!/usr/bin/env python3
"""The variant study of the LogSV path loop on one CUDA GPU (built for
sm_90a, an H100): path-steps/s of each Euler-step variant of the
hand-written kernel ``csrc/logsv_variants.cu``, to find where a path-step's
time goes.

    python3 scripts/bench_torch_variants.py [--nb-path 1048576] [--nb-steps 360]

The counterpart of ``main()`` of ``scripts/bench_pallas_variants.py``, with
its list of configurations (variant, block rows, unroll): the block rows
become the CUDA block size, the unroll the step-loop unroll.  For each
configuration it prints one line: the best of 7 timed calls by CUDA events
(seeds 1..7), path-steps/s, the roofline bound of the variant's operations
(``OPS_PER_STEP`` over 67 TFLOP/s, the H100's float32 peak outside the
tensor cores; 8 bytes per path over 3.35 TB/s) and the share of it reached,
and the sanity mean of x + sigma + qvar per path at seed 0, a
distribution-level check so that a variant that is fast because it computes
garbage cannot win unseen.  It prints the card's name and power limit first.
Exits 1 without a CUDA device.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the TPU study's configurations: (variant, block rows, unroll)
CONFIGS = [("poly-bm", 256, 2), ("sigma-carry", 256, 2), ("no-qvar", 256, 2),
           ("sigma-carry-noqvar", 256, 2), ("poly-bm", 256, 2),
           ("sigma-carry", 256, 2), ("sigma-carry-noqvar", 256, 2),
           ("alu-floor", 256, 2)]
PEAK_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores, at 700 W
PEAK_BYTES_PER_S = 3.35e12
DT = 1.0 / 360.0


def bound_ms(variant: str, nb_path: int, nb_steps: int) -> float:
    from stochvolmodels_torch.ops.mc_variants import OPS_PER_STEP
    ops = sum(OPS_PER_STEP[variant]) * nb_path * nb_steps
    return 1e3 * max(ops / PEAK_OPS_PER_S, 8 * nb_path / PEAK_BYTES_PER_S)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nb-path", type=int, default=1 << 20)
    parser.add_argument("--nb-steps", type=int, default=360)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from stochvolmodels_torch.ops.mc_variants import run_variant_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"{args.nb_path} paths x {args.nb_steps} steps", flush=True)
    x0 = torch.zeros(args.nb_path, dtype=torch.float32, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for variant, block_rows, unroll in CONFIGS:
        def run(seed):
            return run_variant_cuda(seed, x0, args.nb_steps, DT, variant,
                                    block_rows=block_rows, unroll=unroll)

        sanity = float(run(0).double().sum()) / args.nb_path
        best = float("inf")
        for r in range(7):
            start.record()
            run(r + 1)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        rate = args.nb_path * args.nb_steps / best * 1e3
        bound = bound_ms(variant, args.nb_path, args.nb_steps)
        print(f"{variant:18s} rows={block_rows:3d} unroll={unroll}  {rate:.4e} path-steps/s   "
              f"best {best:.4f} ms   bound {bound:.4f} ms ({bound / best:.1%})   "
              f"sanity mean(x+sig+qvar)={sanity:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
