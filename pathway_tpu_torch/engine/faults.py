"""Deterministic fault injection for the exchange mesh.

Counterpart of ``pathway_tpu/engine/faults.py``: the same plan and seed make the same
decisions. A :class:`FaultPlan` is loaded from ``PATHWAY_TPU_FAULT_PLAN`` — either
inline JSON or a path to a JSON file — and injects failures at the two
seams the fault-tolerance layer defends:

- ``on_commit(process_id, time)`` fires AFTER a commit's operator
  snapshot is written (the clean recovery boundary).  A matching
  ``kill`` fault SIGKILLs the process — indistinguishable from an OOM
  kill or a machine loss from the mesh's point of view.
- ``on_send(process_id, peer, frame)`` fires before every mesh frame is
  written to the socket.  ``drop`` swallows the frame, ``delay`` sleeps
  before sending, ``dup`` sends it twice, ``reset`` hard-closes the
  socket mid-stream (a synthetic RST).

Plan format (JSON object)::

    {"seed": 7,
     "faults": [
       {"type": "kill",  "process": 1, "at_commit": 3},
       {"type": "drop",  "process": 1, "peer": 0, "kind": "hb",
        "count": 2},
       {"type": "delay", "process": 2, "kind": "round", "count": 3,
        "ms": 50},
       {"type": "dup",   "process": 1, "kind": "round", "count": 1},
       {"type": "reset", "process": 1, "peer": 0, "after_sends": 10}
     ]}

Selectors: ``process`` (required — which worker the fault lives in;
``"*"``, ``"all"`` or ``-1`` match every worker, so a wildcard ``kill``
at one commit is a total-mesh kill — the cold-restart scenario),
``peer`` (optional — only frames bound for that peer), ``kind``
(optional — only frames whose tuple tag matches, e.g. ``"round"``,
``"hb"``, ``"cmd"``), ``count`` (how many frames to affect; default 1),
``at_commit`` (kill boundary), ``after_sends`` (matching sends to let
through before a reset fires).  Jitter drawn inside the plan uses
``random.Random(seed)`` so a plan replays identically.

The plan is a lazy module singleton: when ``PATHWAY_TPU_FAULT_PLAN`` is
unset the hot-path cost is one ``None`` check per send.
"""

from __future__ import annotations

import json
import os
import random
import signal
import time as _walltime
from typing import Any


class _Fault:
    __slots__ = (
        "type", "process", "peer", "kind", "count", "at_commit",
        "after_sends", "ms", "_sends_seen",
    )

    def __init__(self, spec: dict) -> None:
        self.type = spec["type"]
        if self.type not in ("kill", "drop", "delay", "dup", "reset"):
            raise ValueError(f"unknown fault type {self.type!r}")
        # process "*" / "all" / -1 matches every worker — the total-kill
        # spelling used by the cold-restart scenario (a kill fault with a
        # wildcard process takes the whole mesh down at one commit)
        proc = spec["process"]
        if proc in ("*", "all"):
            self.process = -1
        else:
            self.process = int(proc)
        self.peer = spec.get("peer")
        self.kind = spec.get("kind")
        self.count = int(spec.get("count", 1))
        self.at_commit = spec.get("at_commit")
        self.after_sends = int(spec.get("after_sends", 0))
        self.ms = float(spec.get("ms", 0.0))
        self._sends_seen = 0

    def matches_process(self, process_id: int) -> bool:
        return self.process == -1 or self.process == process_id

    def matches_frame(self, peer: int, frame: Any) -> bool:
        if self.count <= 0:
            return False
        if self.peer is not None and int(self.peer) != peer:
            return False
        if self.kind is not None:
            tag = frame[0] if isinstance(frame, tuple) and frame else None
            if tag != self.kind:
                return False
        if self.after_sends:
            self._sends_seen += 1
            if self._sends_seen <= self.after_sends:
                return False
        return True


class FaultPlan:
    """Parsed fault plan; see module docstring for the JSON format."""

    def __init__(self, spec: dict) -> None:
        self.seed = int(spec.get("seed", 0))
        self.rng = random.Random(self.seed)
        self.faults = [_Fault(f) for f in spec.get("faults", [])]
        # a restarted worker re-parses the same plan, so without credit
        # its kill fault would fire again on every incarnation — the
        # supervisor stamps how many restarts this slot has had, and we
        # treat that many kill firings as already consumed
        try:
            self._kill_credit = int(
                os.environ.get("PATHWAY_TPU_RESTART_COUNT", "0")
            )
        except ValueError:
            self._kill_credit = 0

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        raw = os.environ.get("PATHWAY_TPU_FAULT_PLAN")
        if not raw:
            return None
        raw = raw.strip()
        if not raw.startswith("{"):
            with open(raw, "r", encoding="utf-8") as fh:
                raw = fh.read()
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"PATHWAY_TPU_FAULT_PLAN is not valid JSON: {exc}"
            ) from exc
        return cls(spec)

    # -- injection seams -----------------------------------------------------

    def on_commit(self, process_id: int, time: int) -> None:
        """Called after the commit-boundary snapshot write.  A matching
        ``kill`` fault SIGKILLs this worker — the snapshot for ``time``
        is durable, everything after it is lost."""
        for f in self.faults:
            if (
                f.type == "kill"
                and f.matches_process(process_id)
                and f.at_commit is not None
                and time >= int(f.at_commit)
                and f.count > 0
            ):
                f.count -= 1
                if self._kill_credit > 0:
                    self._kill_credit -= 1
                    continue  # fired in a previous incarnation
                from pathway_tpu_torch.internals.metrics import FLIGHT

                FLIGHT.record(
                    "fault_kill", process=process_id, time=time
                )
                FLIGHT.dump("fault-injected kill")
                os.kill(os.getpid(), signal.SIGKILL)

    def on_send(self, process_id: int, peer: int, frame: Any) -> str:
        """Consulted by ``MeshTransport.send``.  Returns the action for
        this frame: ``"send"`` (default), ``"drop"``, ``"dup"``, or
        ``"reset"``; a ``delay`` fault sleeps here and then sends."""
        for f in self.faults:
            if not f.matches_process(process_id) or f.type == "kill":
                continue
            if not f.matches_frame(peer, frame):
                continue
            f.count -= 1
            if f.type == "delay":
                # deterministic jitter: up to 20% around the nominal delay
                ms = f.ms * (0.9 + 0.2 * self.rng.random())
                _walltime.sleep(ms / 1000.0)
                return "send"
            return f.type
        return "send"


_PLAN: FaultPlan | None = None
_LOADED = False


def active_plan() -> FaultPlan | None:
    """The process-wide plan (lazily parsed from the environment)."""
    global _PLAN, _LOADED
    if not _LOADED:
        _PLAN = FaultPlan.from_env()
        _LOADED = True
    return _PLAN


def reset_plan() -> None:
    """Forget the cached plan (tests that mutate the env call this)."""
    global _PLAN, _LOADED
    _PLAN = None
    _LOADED = False
