"""Shared helpers of ``tests/test_torch_scripts_*.py``: the example and
paper scripts run through the port and through the JAX package by
``scripts/port_scripts.py``, one fresh interpreter a side.

A test file takes a group of scripts.  Its module fixture runs the group's
tier-1 entries (and imports each of its in-reach modules through the
redirect) in one port-side and one JAX-side interpreter, started together;
each slow entry (both sides together past ~20 s on one CPU core) runs in
interpreters of its own.  The tolerances are the runner's, by kind of entry
(``port_scripts.TOLERANCES``).
"""
import importlib.util
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("port_scripts", ROOT / "scripts" / "port_scripts.py")
port_scripts = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("port_scripts", port_scripts)
_spec.loader.exec_module(port_scripts)

# a side runs at most this long (the slowest tier-1 group takes ~2 min on one core)
SIDE_TIMEOUT_S = 900


def group(prefixes):
    """(modules, tier-1 entries, slow entries) of the scripts whose path
    starts with one of ``prefixes``."""
    match = lambda path: path.startswith(tuple(prefixes))
    modules = [m for m in port_scripts.in_reach_modules() if match(m)]
    names = [e.name for e in port_scripts.entries() if match(e.path)]
    return (modules, [n for n in names if n not in port_scripts.SLOW],
            [n for n in names if n in port_scripts.SLOW])


def run_both(names, imports=()):
    """{"port": records, "jax": records} of ``names`` (and the port side's
    imports of ``imports``), both sides started together."""
    with ThreadPoolExecutor(2) as pool:
        port = pool.submit(port_scripts.spawn_side, "port", names, imports, SIDE_TIMEOUT_S)
        ref = pool.submit(port_scripts.spawn_side, "jax", names, (), SIDE_TIMEOUT_S)
        return {"port": port.result(), "jax": ref.result()}


def check_entry(name, sides):
    """the entry ran on both sides (or failed on both with the same error,
    where it fails on the JAX package), the port side loaded nothing of
    JAX, and what it produced is within its kind's tolerance of the JAX
    run."""
    port, ref = sides["port"].get(name), sides["jax"].get(name)
    done = sides["port"]["__done__"]
    assert port is not None, f"the port side did not reach {name}: {done}"
    assert ref is not None, f"the JAX side did not reach {name}: {sides['jax']['__done__']}"
    if name not in port_scripts.JAX_FAILS:
        assert ref["ok"], f"the JAX run failed: {ref.get('error')}"
        assert port["ok"], f"the port run failed: {port.get('error')}"
    assert port["foreign"] == [], port["foreign"]
    verdict = port_scripts.judge(name, port, ref)
    assert verdict["ok"], verdict


def check_import(path, sides):
    rec = sides["port"].get(f"import:{path}")
    assert rec is not None, sides["port"]["__done__"]
    assert rec["ok"], rec.get("error")
    assert rec["foreign"] == [], rec["foreign"]


def check_done(sides):
    """the port side ran to its end with every CUDA device default of the
    port rewritten to the CPU, and loaded nothing of JAX."""
    done = sides["port"]["__done__"]
    assert done.get("done") == "port", done
    assert done["rewritten"] >= 40, done
    assert done["foreign"] == [], done["foreign"]

