"""
Benchmark of ``stochvolmodels_torch`` on one cell: one configuration under
one traffic mix, driven by one client in a closed loop (each request waits
for the previous answer, as a desk's researcher or refit job does).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes its inputs from the seed, sets up the program and warms the
cell's shapes (``setup_s``), then either drives requests for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics) or traces the traffic's fixed
number of requests with torch.profiler (``--trace 1``: its per-layer
metrics).  After the window it checks a sample of the answers, drawn from
the seed, against the plain reference (``port_bench/reference/``) and prints
one JSON line last.  Without a CUDA card it exits non-zero and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402


BENCH_DIR = Path(__file__).resolve().parent
# the benchmark's own modules, and the checkout's root, where the program lives
for _path in (BENCH_DIR.parent, BENCH_DIR):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

from bench_lib import cells, guard  # noqa: E402


class Context:
    """what the readers of end-to-end metrics see of a timed window."""

    def __init__(self, setup_s, latencies, window_s):
        self.setup_s, self.latencies, self.window_s = setup_s, latencies, window_s


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _device_record(torch, device) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def _steal_s():
    """seconds of CPU time, over all cores, that the hypervisor gave to other
    machines (``/proc/stat``); None where that is not readable."""
    try:
        fields = Path("/proc/stat").read_text().split("\n", 1)[0].split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def _sample(seed: int, n_done: int, n_checks: int) -> list:
    """the request indices that the reference checks, drawn from the seed."""
    import numpy as np

    g = np.random.default_rng([int(seed), 2])
    return sorted(int(k) for k in g.choice(n_done, size=min(n_checks, n_done), replace=False))


def run(argv=None, device: str = None, overrides: dict = None, root: Path = None) -> dict:
    """one run of a cell; returns the result line's object.  ``device`` None
    requires a CUDA card (the benchmark); "cpu" skips that look, for tests,
    which pass ``overrides`` ({"config": ..., "traffic": ...}) to shrink the
    sizes and ``root`` to read another BENCHMARK.json."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise SystemExit("port_bench: no CUDA card; the benchmark measures the card only")
        device = "cuda"
    device = torch.device(device)
    cell = cells.resolve(args.workload, root=root)
    if device.type == "cuda" and torch.cuda.device_count() < int(cell.spec.get("chips", 1)):
        raise SystemExit(f"port_bench: {cell.name} needs {cell.spec['chips']} cards")
    overrides = overrides or {}
    config = _merge(cell.config, overrides.get("config"))
    traffic = _merge(cell.traffic, overrides.get("traffic"))
    entry = cell.entry().Entry(cell, args.seed, device, config, traffic)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    entry.setup()
    sync()
    failed, outputs, latencies, cpu_s = 0, {}, [], []

    def one(k):
        nonlocal failed
        inputs = entry.make(k)
        c0 = time.process_time()
        t0 = time.perf_counter()
        try:
            out = entry.call(inputs)
        except Exception:  # a failed request counts, and fails the run's check
            print(f"port_bench: request {k} failed:\n{traceback.format_exc()}", file=sys.stderr)
            failed += 1
            out = None
        latencies.append(time.perf_counter() - t0)
        cpu_s.append(time.process_time() - c0)
        outputs[k] = (inputs, out)

    setup_s = time.perf_counter() - T_START
    steal0 = _steal_s()
    trace = None
    if args.trace:
        from bench_lib import trace as tr

        n = int(traffic["trace_requests"])
        # requests that run under the profiler before the traced ones, so
        # that its own start-up falls outside the spans the metrics read
        warm = int(traffic.get("trace_warmup", 0))

        def requests():
            for k in range(warm):
                one(k)
            for k in range(warm, warm + n):
                with torch.profiler.record_function(tr.REQUEST_SPAN):
                    one(k)

        trace = tr.record(requests, n)
        trace.info, trace.setup = entry.trace_info(), dict(entry.setup_spans)
        window_s = trace.window_s
    else:
        t_window = time.perf_counter()
        k = 0
        while time.perf_counter() - t_window < args.seconds:
            one(k)
            k += 1
        window_s = time.perf_counter() - t_window
    steal1 = _steal_s()
    attempted = len(outputs)
    lat = [1e3 * t for t in latencies]
    if len(lat) > 1:
        q = statistics.quantiles(lat, n=4)
        print(f"port_bench: {len(lat)} requests, ms min {min(lat):.3f} q1 {q[0]:.3f} median "
              f"{q[1]:.3f} q3 {q[2]:.3f} max {max(lat):.3f}; set-up {setup_s:.3f} s",
              file=sys.stderr)
        # where the slow requests' time went: host CPU time of the process
        # against wall time, and time the hypervisor took from the machine
        slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:3]
        steal = "n/a" if steal0 is None or steal1 is None else f"{steal1 - steal0:.3f} s"
        print(f"port_bench: host cpu ms a request, median {1e3 * statistics.median(cpu_s):.3f}; "
              "slowest (request, wall ms, cpu ms) "
              + ", ".join(f"({i}, {lat[i]:.3f}, {1e3 * cpu_s[i]:.3f})" for i in slow)
              + f"; steal over the window {steal}", file=sys.stderr)
    record = _device_record(torch, device)
    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: a sample of the window's answers against the plain reference
    checks = {}
    limits = config["limits"][traffic["entry"]]
    for k in _sample(args.seed, attempted, int(traffic["checks"])):
        inputs, out = outputs[k]
        ref = entry.reference(inputs)
        got = {n: math.inf for n in limits} if out is None else entry.gaps(out, ref)
        for name, value in got.items():
            value = value if math.isfinite(value) else math.inf
            checks[name] = max(checks.get(name, 0.0), value)
    correct = failed == 0 and bool(checks) and all(
        math.isfinite(v) and v <= limits[n] for n, v in checks.items())

    metrics = {}
    if trace is not None:
        record["busy_s"], record["window_s"] = trace.busy_s, trace.window_s
        ctx = trace
    else:
        ctx = Context(setup_s, latencies, window_s)
    for m in cell.metrics(bool(args.trace)):
        value = cell.reader(m).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = guard.forbidden_loaded()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    result = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                  device=record)
    if trace is not None:
        result["breakdown"] = dict(device_ops=trace.device_ops(), idle_gaps=trace.idle_gaps())
    # a comparison that found no number (inf) prints as the largest float
    result["checks"] = {n: {"value": min(v, sys.float_info.max), "limit": limits[n]}
                        for n, v in checks.items()}
    return result


def main(argv=None) -> int:
    guard.pin_caches(BENCH_DIR.parent)
    # one client process with few host threads: the host work of a request is
    # small and serial, and idle worker threads only add jitter
    threads = int(os.environ.setdefault("OMP_NUM_THREADS", "1"))
    import torch

    torch.set_num_threads(threads)
    result = run(argv)
    if result["device"]["platform"] == "gpu":
        from bench_lib import yardstick

        print(f"port_bench: card {yardstick.smi_name_and_power()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
