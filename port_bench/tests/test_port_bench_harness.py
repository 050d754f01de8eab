"""
CPU tests of the benchmark harness: every cell resolves by name to its
files, the result line has the contract's keys, a cell can be added with new
files only, the loaded-module guard, and the roofline and mfu arithmetic on
hand-worked numbers.

    python -m pytest port_bench/tests -q
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (ROOT, BENCH_DIR):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import run  # noqa: E402
from bench_lib import cells, guard, trace, yardstick  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
TINY = {"config": {"lm": {"nb_iters": 1, "year_steps": 30}},
        "traffic": {"nb_path": 2048, "checks": 1, "trace_requests": 1}}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    assert cell.config["model"] and cell.traffic["entry"]
    assert hasattr(cell.entry(), "Entry")
    assert hasattr(cell.model(), "Program")
    assert hasattr(cell.reference(), "fit") and hasattr(cell.reference(), "mc_prices")
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(metric).read), metric["name"]
    assert set(cell.config["limits"][cell.traffic["entry"]])
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_every_metric_has_a_reader_and_a_known_cell():
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
        assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_result_line_has_the_contract_keys():
    result = run.run(["--workload", "heston_btc.mc_chain", "--seed", "3000000019",
                      "--seconds", "0.5"], device="cpu", overrides=TINY)
    assert list(result) == CONTRACT_KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "mc_chain_ms", "mc_chain_p95_ms"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.loads(json.dumps(result))


def test_traced_result_line_adds_the_breakdown():
    result = run.run(["--workload", "logsv_btc.mc_chain", "--seed", "5", "--seconds", "1",
                      "--trace", "1"], device="cpu", overrides=TINY)
    assert list(result) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_no_card_fails_without_a_result():
    with pytest.raises(SystemExit) as exc:
        run.run(["--workload", "heston_btc.mc_chain", "--seed", "1", "--seconds", "1"])
    assert exc.value.code not in (0, None)


def test_a_new_cell_needs_new_files_only(tmp_path):
    """a throwaway cell with a configuration, a model adapter (with its own
    frozen operation count), a plain reference, a traffic mix and a metric
    of its own, each added as a new file, and new entries in a copy of
    BENCHMARK.json, runs through the harness, traced and untraced."""
    bench_dir = tmp_path / BENCH_DIR.name
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((BENCH_DIR / "configs" / "heston_btc.json").read_text())
    (bench_dir / "configs" / "twin_btc.json").write_text(json.dumps(dict(config, model="twin")))
    (bench_dir / "models" / "twin.py").write_text(
        (BENCH_DIR / "models" / "heston.py").read_text().replace(
            "OPS_PER_STEP = (68, 34)", "OPS_PER_STEP = (1000, 0)"))
    (bench_dir / "reference" / "twin.py").write_text("from .heston import *  # noqa: F401,F403\n")
    (bench_dir / "traffic" / "mc_small.json").write_text(json.dumps(
        {"entry": "mc_chain", "nb_path": 1024, "checks": 1, "trace_requests": 1}))
    (bench_dir / "metrics" / "path_ops.py").write_text(
        "def read(trace):\n    return trace.info['path_ops']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "twin_btc", "source": "a test configuration",
                             "file": "port_bench/configs/twin_btc.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "twin_btc.mc_small", "config": "twin_btc",
                               "traffic": "mc_small", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "path_ops", "unit": "ops", "better": "lower",
                               "source": "device_trace", "layer": "MC path loops",
                               "moves": "mc_chain_ms", "workloads": ["twin_btc.mc_small"]})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "heston_btc.mc_chain" in metric.get("workloads", []):
            metric["workloads"].append("twin_btc.mc_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    argv = ["--workload", "twin_btc.mc_small", "--seed", "77", "--seconds", "0.5"]
    result = run.run(argv, device="cpu", root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "mc_chain_ms", "mc_chain_p95_ms"}
    traced = run.run(argv[:-1] + ["0.5", "--trace", "1"], device="cpu", root=tmp_path)
    assert traced["correct"] is True
    # the twin's own count reached the yardstick: 1,024 paths of 16 + 22 + 36 + 84
    # steps (the chain's slices at 360 steps a year), 1,000 operations a step
    assert traced["metrics"]["path_ops"]["value"] == 1024 * 158 * 1000
    assert {"mc_chain_mfu", "payoff_device_ms"} <= set(traced["metrics"])


def test_guard_compares_whole_top_level_names():
    names = ["jax.numpy", "jaxlib", "flax.linen", "stochvolmodels_tpu.ops", "stochvolmodels",
             "stochvolmodels.data", "stochvolmodels_torch", "stochvolmodels_torch.ops.mc",
             "jaxtyping", "numpy"]
    assert guard.forbidden_loaded(names) == ["flax.linen", "jax.numpy", "jaxlib",
                                             "stochvolmodels", "stochvolmodels.data",
                                             "stochvolmodels_tpu.ops"]


def test_a_run_loads_nothing_forbidden():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; from bench_lib import guard; "
            "run.run(['--workload', 'heston_btc.mc_chain', '--seed', '9', '--seconds', '0.1'], "
            "device='cpu', overrides={'traffic': {'nb_path': 1024}}); "
            "print('FORBIDDEN', guard.forbidden_loaded())" % (str(ROOT), str(BENCH_DIR)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_mc_chain_work_by_hand():
    work = yardstick.mc_chain_work((68, 34), [0.1, 0.25], [2, 3], nb_path=200, year_steps=100)
    # 200 paths pad to 256; int(0.1 * 100) + 1 = 11 and int(0.15 * 100) + 1 = 16 steps
    assert work["path_steps"] == 256 * 27
    assert work["path_ops"] == 256 * 27 * (68 + 34)
    assert work["path_bytes"] == 24 * 256 * 2
    assert work["payoff_ops"] == 200 * (4 + 6 * 2) + 200 * (4 + 6 * 3)
    # the operations bound: 705,024 / 67e12 s beats 12,288 / 3.35e12 s
    assert yardstick.path_loop_least_s(work) == pytest.approx(705024 / 67e12, rel=1e-15)
    assert yardstick.chain_call_least_s(work) == pytest.approx(705024 / 67e12 + 7600 / 34e12,
                                                               rel=1e-15)


def test_bytes_bound_where_steps_are_few():
    work = yardstick.mc_chain_work((73, 34), [0.001], [1], nb_path=128, year_steps=1)
    # one step: 128 x 107 operations take 2.04e-10 s; 3,072 bytes take 9.17e-10 s
    assert yardstick.path_loop_least_s(work) == pytest.approx(3072 / 3.35e12, rel=1e-15)


def _trace(kernels, window, n, **info):
    return trace.Trace(kernels=kernels, host=[], window=window, n_requests=n, info=info)


def test_roofline_mfu_and_idle_readers_by_hand():
    work = yardstick.mc_chain_work((68, 34), [0.1, 0.25], [2, 3], nb_path=2 ** 20,
                                   year_steps=100)
    kernel_ns = int(round(4e9 * yardstick.path_loop_least_s(work)))   # ~172,400 ns
    # two calls in 1 ms; the path kernel takes 4x its least time, payoffs 1,000 ns a call
    k = [("heston_mc_kernel", 0, kernel_ns), ("elementwise", 200_000, 1000),
         ("heston_mc_kernel", 500_000, kernel_ns), ("elementwise", 700_000, 1000)]
    t = _trace(k, (0, 1_000_000), 2, path_kernel="heston_mc_kernel", **work)
    cell = cells.resolve("heston_btc.mc_chain")
    read = {m["name"]: cell.reader(m).read(t) for m in cell.per_layer}
    assert read["mc_kernel_roofline"] == pytest.approx(25.0, rel=1e-5)
    assert read["payoff_device_ms"] == pytest.approx(1e-3, rel=1e-12)
    assert read["mc_chain_mfu"] == pytest.approx(
        100 * 2 * yardstick.chain_call_least_s(work) / 1e-3, rel=1e-12)
    busy = 2 * (kernel_ns + 1000)
    assert read["device_idle.mc_chain"] == pytest.approx(100 * (1 - busy / 1e6), rel=1e-12)


def test_calib_readers_and_busy_union_by_hand():
    # overlapping records count once: [0, 300) and [200, 500) are 500 ns busy
    k = [("a", 0, 300), ("b", 200, 300), ("c", 800, 100)]
    t = _trace(k, (0, 1000), 1)
    t.setup = {"graph_capture_s": 21.5, "graph_captures": 1}
    cell = cells.resolve("logsv_btc.calib_lm")
    read = {m["name"]: cell.reader(m).read(t) for m in cell.per_layer}
    assert read["calib_kernels"] == 3
    assert read["calib_busy_ms"] == pytest.approx(600e-6, rel=1e-12)
    assert read["graph_capture_s"] == 21.5
    t.setup["graph_captures"] = 0
    assert cell.reader({"name": "graph_capture_s"}).read(t) is None


def test_records_before_the_first_span_stay_outside_the_window():
    """a request that warms the profiler before the traced ones leaves its
    device records out of the window's counts."""
    import torch

    calls = []

    def requests():
        calls.append(torch.ones(64).sum())                # a warm-up, outside any span
        for _ in range(2):
            with torch.profiler.record_function(trace.REQUEST_SPAN):
                calls.append(torch.ones(64).sum())

    t = trace.record(requests, 2)
    assert t.n_requests == 2 and len(t.spans) == 2
    assert all(t.window[0] <= s < t.window[1] for _, s, _ in t.kernels)
    assert all(s + d > t.window[0] for _, s, d in t.host)


def test_idle_gaps_are_named_by_the_host():
    t = trace.Trace(kernels=[("k", 100, 100), ("k", 600, 100)],
                    host=[("aten::copy_", 150, 500)], window=(0, 1000), n_requests=1,
                    spans=[("bench.request", 0, 1000)])
    gaps = t.idle_gaps()
    assert gaps[0][0] == "host: aten::copy_"
    assert [g[1] for g in gaps] == pytest.approx([400e-9, 300e-9, 100e-9], rel=1e-12)
    assert gaps[-1][0] == "host: inside a request, no op recorded"


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run.run(["--workload", "heston_btc.mc_chain", "--seed", "3000000001",
                      "--seconds", "2"])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
