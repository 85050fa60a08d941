"""The port's lock-order watcher against the JAX package's
(``internals/lockwatch.py``). ``install`` patches ``threading`` for the whole process,
so every case runs in a fresh interpreter with ``PATHWAY_TPU_LOCKWATCH=1``: A -> B then
B -> A records one cycle, with the same report keys, flight event kind and metric
families, and the same report file (sites differ by line number, so shapes are
compared); a re-entered RLock records no edge; ``Condition.wait`` on a watched lock
works. Importing the port before torch installs the watcher and torch still imports,
with a ``ThreadPoolExecutor`` running after; the JAX package's wrapper has no
``_at_fork_reinit``, so importing ``concurrent.futures.thread`` after its install
raises."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


def _child(code: str, tmp_path, *, watch: bool = True) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PATHWAY_TPU_LOCKWATCH_DIR=str(tmp_path))
    env["PATHWAY_TPU_LOCKWATCH"] = "1" if watch else "0"
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)


def _json(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


WATCHED = """
import json, threading
import {pkg}
from {pkg}.internals import lockwatch, metrics

# a reentered RLock alone
q = threading.RLock()
with q:
    with q:
        with q:
            pass
reentry = {{"edges": {{k: sorted(v) for k, v in lockwatch._ORDER.items()
                     if q._name in (k, *v)}}, "cycles": len(lockwatch.cycles())}}

# Condition.wait on a watched Lock and on a watched RLock held once
cond = threading.Condition(threading.Lock())
rcond = threading.Condition()
flags = []

def notify(c):
    with c:
        flags.append(1)
        c.notify()

woke = []
for c in (cond, rcond):
    with c:
        t = threading.Thread(target=notify, args=(c,))
        t.start()
        woke.append(c.wait_for(lambda: len(flags) >= len(woke) + 1, timeout=10))
    t.join()
condition = {{"woke": woke, "watched": type(cond._lock).__name__}}

# A -> B, then B -> A closes a cycle; r -> a once under re-entries
a = threading.Lock()
b = threading.Lock()
with a:
    with b:
        pass
with b:
    with a:
        pass
r = threading.RLock()
with r:
    with r:
        with a:
            pass
cycles = lockwatch.cycles()
snap = metrics.REGISTRY.snapshot()
flight = [e for e in metrics.FLIGHT.snapshot() if e["kind"] == "lock_order_cycle"]
print(json.dumps({{"reentry": reentry, "condition": condition, "cycle": {{
    "installed": lockwatch._INSTALLED,
    "wrapped": type(a).__name__,
    "cycles": [sorted(c) for c in cycles],
    "cycle_len": [len(c["cycle"]) for c in cycles],
    "closing": [c["closing_edge"] for c in cycles],
    "a_b": [a._name, b._name],
    "r_edges": sorted(lockwatch._ORDER.get(r._name, {{}})),
    "flight": [sorted(e) for e in flight],
    "families": {{f: sorted(s["labels"]) for f in ("pathway_lock_hold_seconds_max",
                 "pathway_lock_acquisitions_total") for s in snap[f]["series"][:1]}},
    "a_acquired": [s["value"] for s in snap["pathway_lock_acquisitions_total"]["series"]
                   if s["labels"]["lock"] == a._name],
}}}}))
"""


@pytest.fixture(scope="module")
def watched(tmp_path_factory) -> dict:
    """One watched child per package (each a fresh interpreter), with its report
    files' contents."""
    got = {}
    for pkg in PACKAGES:
        d = tmp_path_factory.mktemp(pkg)
        got[pkg] = _json(_child(WATCHED.format(pkg=pkg), d))
        reports = [n for n in os.listdir(d) if n.startswith("pathway_lockwatch_cycle_p")]
        lines = []
        for name in reports:
            with open(d / name) as fh:
                lines += [json.loads(ln) for ln in fh]
        got[pkg]["cycle"]["report"] = [(sorted(r), r["kind"], len(r["cycle"])) for r in lines]
    return got


def test_a_cycle_is_recorded_alike(watched):
    got = {pkg: watched[pkg]["cycle"] for pkg in PACKAGES}
    # the child's own locks are named by its code's lines, the same in both packages
    assert got["pathway_tpu"] == got["pathway_tpu_torch"]
    want = got["pathway_tpu_torch"]
    a_name, b_name = want["a_b"]
    assert want["installed"] and want["wrapped"] == "_WatchedLock"
    assert want["cycles"] == [["closing_edge", "cycle", "kind", "pid", "wall"]]
    assert want["cycle_len"] == [3] and want["closing"] == [[b_name, a_name]]
    assert want["r_edges"] == [a_name]  # r -> a once, the re-entries add nothing
    assert want["report"] == [(["closing_edge", "cycle", "kind", "pid", "wall"], "lock_order_cycle", 3)]
    assert want["families"] == {"pathway_lock_hold_seconds_max": ["lock"],
                                "pathway_lock_acquisitions_total": ["lock"]}
    assert want["a_acquired"] == [3.0]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_a_reentered_rlock_records_no_edge(pkg, watched):
    assert watched[pkg]["reentry"] == {"edges": {}, "cycles": 0}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_condition_wait_on_a_watched_lock_works(pkg, watched):
    assert watched[pkg]["condition"] == {"woke": [True, True], "watched": "_WatchedLock"}


TORCH_AFTER = """
import json, threading, sys
assert "torch" not in sys.modules
import pathway_tpu_torch
import torch
from concurrent.futures import ThreadPoolExecutor
from pathway_tpu_torch.internals import lockwatch, metrics
with ThreadPoolExecutor(2) as ex:
    squares = list(ex.map(lambda x: x * x, range(6)))
sites = [s["labels"]["lock"] for s in metrics.REGISTRY.snapshot().get(
    "pathway_lock_acquisitions_total", {"series": []})["series"]]
print(json.dumps({"installed": lockwatch._INSTALLED, "squares": squares,
                  "wrapped": type(threading.Lock()).__name__,
                  "metrics_site": any(s.startswith("metrics.py:") for s in sites),
                  "cycles": len(lockwatch.cycles())}))
"""


def test_the_port_installs_before_torch_and_torch_imports(tmp_path):
    got = _json(_child(TORCH_AFTER, tmp_path))
    assert got == {"installed": True, "squares": [0, 1, 4, 9, 16, 25], "wrapped": "_WatchedLock",
                   "metrics_site": True, "cycles": 0}
    plain = _json(_child(TORCH_AFTER, tmp_path, watch=False))
    assert plain == {"installed": False, "squares": [0, 1, 4, 9, 16, 25], "wrapped": "lock",
                     "metrics_site": False, "cycles": 0}


FORK_HOOK = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("lw", {path!r})
lw = importlib.util.module_from_spec(spec)
spec.loader.exec_module(lw)
lw.install()
import concurrent.futures.thread
print("imported")
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_only_the_ports_wrapper_answers_the_fork_hook(pkg, tmp_path):
    """``concurrent.futures.thread`` registers ``_global_shutdown_lock._at_fork_reinit``
    at import (``import torch`` reaches it): the port's wrapper delegates it, the JAX
    package's raises ``AttributeError``. Each module is loaded alone from its file."""
    path = os.path.join(REPO, pkg, "internals", "lockwatch.py")
    proc = _child(FORK_HOOK.format(path=path), tmp_path, watch=False)
    if pkg == "pathway_tpu_torch":
        assert proc.returncode == 0 and proc.stdout.strip() == "imported", proc.stderr
    else:
        assert proc.returncode != 0 and "_at_fork_reinit" in proc.stderr
