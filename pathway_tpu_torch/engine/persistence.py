"""Engine persistence: backends, input-event journals, resumable drivers and operator
snapshots.

Counterpart of ``pathway_tpu/engine/persistence.py``. The journal of a persistent
source is a sequence of pickled *segments*, one per commit that had events:
``{"events": [(kind, key, row, source_id), ...], "reader": state, "seq": n}``. A crash
in the middle of an append leaves a truncated tail that replay stops at, so a restart
resumes from the last complete commit. Operator persistence
(``PersistenceMode.OPERATOR_PERSISTING``) writes every node's state and every driver's
position instead, at commit boundaries, and a restart restores them with no replay.

An operator snapshot holds one state list per worker: a sharded run (workers in one
process) writes each replica's, and a restart at another worker count re-splits them
along the sharded scheduler's own routing (:func:`_reshard_worker_states`). The
multi-process runner keeps one snapshot per process (``operator-snapshot-p<id>``) with
a ring of the last few commits (``retain``, ``restore(at_time=...)``), so a mesh rolls
back to a commit every process still holds; :func:`reshard_process_snapshots` rewrites
a quiesced mesh's snapshots for another process count.
"""

from __future__ import annotations

import io
import os
import pickle
import time as _time
from typing import Any, Iterator
from urllib.parse import quote

import numpy as np

from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.engine.value import Pointer


class PersistenceBackend:
    """Append, overwrite and read named binary streams."""

    def append(self, name: str, payload: bytes) -> None:
        raise NotImplementedError

    def write(self, name: str, payload: bytes) -> None:
        """Atomic overwrite."""
        raise NotImplementedError

    def read(self, name: str) -> bytes:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError


class FileBackend(PersistenceBackend):
    """One file a stream under ``root``; writes go through a temporary file, an fsync
    and a rename."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        # collision-free escaping: distinct names never share a file
        return os.path.join(self.root, quote(name, safe=""))

    def append(self, name: str, payload: bytes) -> None:
        with open(self._path(name), "ab") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())

    def write(self, name: str, payload: bytes) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, name: str) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return b""

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


class MemoryBackend(PersistenceBackend):
    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}

    def append(self, name: str, payload: bytes) -> None:
        self._data[name] = self._data.get(name, b"") + payload

    def write(self, name: str, payload: bytes) -> None:
        self._data[name] = payload

    def read(self, name: str) -> bytes:
        return self._data.get(name, b"")

    def exists(self, name: str) -> bool:
        return name in self._data


class ObjectStoreBackend(PersistenceBackend):
    """Persistence over an S3-shaped object store: ``client`` has ``get_object``,
    ``put_object`` and ``list_objects`` (the seam ``pw.io.s3`` uses, so boto3 or an
    in-memory store drops in). Objects cannot append, so a journal is a run of chunk
    objects under its name, counted on the store."""

    def __init__(self, client: Any, prefix: str = "pathway-persistence") -> None:
        self.client = client
        self.prefix = prefix.rstrip("/")
        self._chunk_counts: dict[str, int] = {}

    def _key(self, name: str, chunk: int | None = None) -> str:
        base = f"{self.prefix}/{quote(name, safe='')}"
        return base if chunk is None else f"{base}/chunk-{chunk:09d}"

    def _chunks(self, name: str) -> list[str]:
        return sorted(k for k, _sig in self.client.list_objects(self._key(name) + "/"))

    def append(self, name: str, payload: bytes) -> None:
        n = self._chunk_counts.get(name)
        if n is None:
            n = len(self._chunks(name))
        self.client.put_object(self._key(name, n), payload)
        self._chunk_counts[name] = n + 1

    def write(self, name: str, payload: bytes) -> None:
        self.client.put_object(self._key(name), payload)

    def read(self, name: str) -> bytes:
        chunks = self._chunks(name)
        if chunks:
            return b"".join(self.client.get_object(k) for k in chunks)
        try:
            return self.client.get_object(self._key(name))
        except Exception:  # noqa: BLE001 — a dict store raises KeyError, boto3 its
            # ClientError(NoSuchKey): either way the stream is absent, a cold start
            return b""

    def exists(self, name: str) -> bool:
        if self._chunks(name):
            return True
        try:
            self.client.get_object(self._key(name))
            return True
        except Exception:  # noqa: BLE001 — see read()
            return False


# -- input journals -----------------------------------------------------------


def _key_bytes(keys: list) -> bytes:
    """Pointers as one buffer of 16 little-endian bytes a key (the host kernels' key
    bytes, or their Python fallback: one format either way)."""
    return np.ascontiguousarray(Columns(len(keys), [], kobjs=keys).kbytes()).tobytes()


class _PackedEvents:
    """A commit's journaled events ``[(kind, key, row, source_id)]`` with the keys as
    one buffer of 16 bytes a key (see :class:`_PointerKeyed`); unpickling gives the
    list back."""

    __slots__ = ("kinds", "kbytes", "rows", "sources")

    def __init__(self, kinds: list, kbytes: bytes, rows: list, sources: list) -> None:
        self.kinds, self.kbytes, self.rows, self.sources = kinds, kbytes, rows, sources

    def __reduce__(self):
        return (_unpack_events, (self.kinds, self.kbytes, self.rows, self.sources))


def _pack_events(events: list) -> Any:
    if not events or not all(type(e[1]) is Pointer for e in events):
        return events
    kb = _key_bytes([e[1] for e in events])
    return _PackedEvents([e[0] for e in events], kb, [e[2] for e in events],
                         [e[3] for e in events])


def _unpack_events(kinds: list, kbytes: bytes, rows: list, sources: list) -> list:
    keys = _unpack_keyed(kbytes, rows, pairs=True)
    return [(kind, key, row, src) for kind, (key, row), src in zip(kinds, keys, sources)]



def _segments(raw: bytes) -> Iterator[dict]:
    """Yield the complete pickled segments; stop silently at a truncated tail."""
    buf = io.BytesIO(raw)
    while True:
        try:
            yield pickle.load(buf)
        except EOFError:
            return
        except (pickle.UnpicklingError, AttributeError, ValueError):
            return  # a truncated or corrupt tail from a crash in an append


class RecordingSession:
    """Proxy in front of an InputSession that journals ``(kind, key, row, source_id)``;
    the source lets replay rebuild the driver's per-source rows without persisting
    them every commit."""

    def __init__(self, session: Any) -> None:
        self._session = session
        self.buffer: list[tuple[str, Any, Any, str | None]] = []
        self._source: str | None = None

    def on_source(self, source_id: str) -> None:
        self._source = source_id

    def insert(self, key: Any, row: tuple) -> None:
        self.buffer.append(("insert", key, row, self._source))
        self._session.insert(key, row)

    def remove(self, key: Any, row: tuple | None = None) -> None:
        self.buffer.append(("remove", key, row, self._source))
        self._session.remove(key, row)

    def take(self) -> list[tuple[str, Any, Any, str | None]]:
        out = self.buffer
        self.buffer = []
        return out


class PersistentDriver:
    """An InputDriver with a journal and replay at startup.

    ``replay()`` runs before the first poll: it pushes the events of every complete
    commit back into the session and restores the reader's position, the driver's key
    sequence and its per-source rows, so nothing read before is emitted twice.
    ``journal_bytes``, ``events_replayed`` and ``replay_seconds`` record what it did."""

    def __init__(self, driver: Any, backend: PersistenceBackend, persistent_id: str) -> None:
        self.driver = driver
        self.backend = backend
        self.name = f"journal-{persistent_id}"
        self.recorder = RecordingSession(driver.session)
        driver.session = self.recorder
        self.replayed = False
        self.journal_bytes = 0
        self.events_replayed = 0
        self.replay_seconds = 0.0

    def effective_autocommit_s(self) -> float:
        # as the reference's run loop reads a wrapped driver: no window, every poll
        # with data commits (and journals) at once
        return 0.0

    # -- replay --------------------------------------------------------------

    def replay(self) -> None:
        t0 = _time.perf_counter()
        self.replayed = True
        raw = self.backend.read(self.name)
        self.journal_bytes = len(raw)
        session = self.recorder._session  # replayed events are journaled already
        reader_state = None
        seq = None
        per_source: dict[str, list] = {}
        for segment in _segments(raw):
            for kind, key, row, source_id in segment["events"]:
                self.events_replayed += 1
                if kind == "insert":
                    session.insert(key, row)
                    if source_id is not None:
                        per_source.setdefault(source_id, []).append((key, row))
                else:
                    session.remove(key, row)
                    if source_id is not None and source_id in per_source:
                        per_source[source_id] = [(k, r) for k, r in per_source[source_id] if k != key]
            reader_state = segment.get("reader", reader_state)
            seq = segment.get("seq", seq)
        if reader_state is not None and hasattr(self.driver.reader, "restore_state"):
            self.driver.reader.restore_state(reader_state)
        if seq is not None:
            self.driver._seq = seq
        if self.driver.reader.replaces_sources:
            self.driver._per_source_rows = {s: rows for s, rows in per_source.items() if rows}
        self.replay_seconds = _time.perf_counter() - t0

    # -- driver protocol -----------------------------------------------------

    def poll(self) -> str:
        assert self.replayed, "PersistentDriver.replay() must run before poll"
        return self.driver.poll()

    def on_commit(self, time: int) -> None:
        events = self.recorder.take()
        if not events:
            return  # no events: the reader's and driver's state did not change
        # one segment a commit with data: the events and the position after them (the
        # reader's state is O(sources), so the journal grows with the data, not with
        # the commits)
        reader = self.driver.reader
        segment = {
            "events": _pack_events(events),
            "reader": reader.state() if hasattr(reader, "state") else None,
            "seq": self.driver._seq,
        }
        blob = pickle.dumps(segment, protocol=4)
        self.backend.append(self.name, blob)
        self.journal_bytes += len(blob)


# -- operator snapshots -------------------------------------------------------


class _PointerKeyed:
    """A ``{Pointer: value}`` dict, or a ``[(Pointer, value)]`` list, as it goes into a
    snapshot: the keys as one 16-byte-per-key buffer (the host kernels' key bytes) and
    the values as a list. Unpickling gives the dict or the list back, so restore reads
    plain containers; pickling a Pointer one object at a time costs about four times an
    int's, and a word count's snapshot holds millions of them."""

    __slots__ = ("kbytes", "values", "pairs")

    def __init__(self, kbytes: bytes, values: list, pairs: bool) -> None:
        self.kbytes, self.values, self.pairs = kbytes, values, pairs

    def __reduce__(self):
        return (_unpack_keyed, (self.kbytes, self.values, self.pairs))


def _pack_keyed(obj: Any) -> Any:
    """``obj`` as a :class:`_PointerKeyed` where it is a dict keyed by Pointers (or a
    list of Pointer-keyed pairs); else ``obj``."""
    if not obj:
        return obj
    if type(obj) is dict:
        keys, values, pairs = list(obj), list(obj.values()), False
    elif type(obj) is list and all(type(p) is tuple and len(p) == 2 for p in obj):
        keys, values, pairs = [p[0] for p in obj], [p[1] for p in obj], True
    else:
        return obj
    if not all(type(k) is Pointer for k in keys):
        return obj
    return _PointerKeyed(_key_bytes(keys), values, pairs)


def _unpack_keyed(kbytes: bytes, values: list, pairs: bool) -> Any:
    kb = np.frombuffer(kbytes, np.uint8).reshape(-1, 16)
    keys = Columns(len(kb), [], kbytes=kb).kobjs()
    return list(zip(keys, values)) if pairs else dict(zip(keys, values))


#: Bumped whenever the derivation of operator STATE changes incompatibly (the
#: class-name signature guards the operator sequence). Format 2: groupby group ids
#: derive with salt b""/b"inst", as ``ref_scalar`` does; format 1 (payloads with no
#: "format" key) salted them with b"groupby", and restoring one would strand every
#: group under a key no new row reaches. Another format is refused at restore.
STATE_FORMAT = 2


class OperatorSnapshotManager:
    """``PersistenceMode.OPERATOR_PERSISTING``: capture every operator's state at
    commit boundaries, restore it at startup and move the readers to their positions,
    with no event replay: a resume costs O(state), not O(history).

    A node is identified by its place in the graph's build order (the same program
    builds the same graph); a signature of class names, the state format and the graph
    optimizer's fingerprint are checked at restore, and a mismatch raises.
    ``snapshot_interval_ms=0`` snapshots at every commit; an interval amortizes the
    cost of a large state over commits, and a final snapshot is taken at the end of a
    run whatever the interval. With ``retain > 1`` each snapshot is also written as
    ``<name>-t<time>`` and the last ``retain`` of them stay addressable by commit time
    (``restore(at_time=...)``): the multi-process runner rolls every process back to a
    commit they all still hold. A time that fell off the ring is blanked (the backends
    have no delete, and an empty blob reads as absent).

    ``write_seconds`` and ``write_bytes`` hold each write's seconds and size (pickling
    included); ``restore_seconds`` and ``restore_bytes`` the restore's."""

    def __init__(
        self,
        backend: PersistenceBackend,
        snapshot_interval_ms: int = 0,
        name: str = "operator-snapshot",
        retain: int = 1,
    ) -> None:
        self.backend = backend
        self.interval = snapshot_interval_ms / 1000.0
        self.name = name
        #: how many commit-boundary snapshots stay addressable by time
        self.retain = max(1, int(retain))
        self._ring: list[int] = []
        self._last_write = 0.0
        self.write_seconds: list[float] = []
        self.write_bytes: list[int] = []
        self.restore_seconds = 0.0
        self.restore_bytes = 0

    # -- capture -------------------------------------------------------------

    @staticmethod
    def _driver_state(driver: Any) -> dict:
        inner = getattr(driver, "driver", driver)
        reader = getattr(inner, "reader", None)
        return {
            "reader": reader.state() if reader is not None and hasattr(reader, "state") else None,
            "seq": getattr(inner, "_seq", 0),
            "per_source": getattr(inner, "_per_source_rows", {}),
            "done": getattr(inner, "done", False),
        }

    @staticmethod
    def _packed(state: dict) -> dict:
        return {**state, "current": _pack_keyed(state["current"])}

    @staticmethod
    def _packed_driver(state: dict) -> dict:
        per_source = {s: _pack_keyed(rows) for s, rows in state["per_source"].items()}
        return {**state, "per_source": per_source}

    @staticmethod
    def _restore_driver(driver: Any, state: dict) -> None:
        inner = getattr(driver, "driver", driver)
        reader = getattr(inner, "reader", None)
        if state.get("reader") is not None and hasattr(reader, "restore_state"):
            reader.restore_state(state["reader"])
        inner._seq = state.get("seq", 0)
        inner._per_source_rows = dict(state.get("per_source", {}))

    @staticmethod
    def _scopes_of(scope: Any) -> list:
        return list(scope) if isinstance(scope, (list, tuple)) else [scope]

    def snapshot(self, scope: Any, drivers: list, time: int) -> None:
        """Write every node's state and every driver's position. ``scope`` is one scope
        or the list of a sharded run's replicas, whose states are kept per worker."""
        t0 = _time.perf_counter()
        scopes = self._scopes_of(scope)
        payload = {
            "format": STATE_FORMAT,
            "sigs": [[type(n).__name__ for n in s.nodes] for s in scopes],
            "per_worker": [[self._packed(n.op_state()) for n in s.nodes] for s in scopes],
            "drivers": [self._packed_driver(self._driver_state(d)) for d in drivers],
            "time": time,
            # the graph optimizer's rewrites: state written under one plan (narrowed
            # arities, fused chains) is valid only under the same plan
            "optimize": list(getattr(scopes[0], "_pw_opt_fingerprint", [])),
        }
        blob = pickle.dumps(payload, protocol=4)
        self.backend.write(self.name, blob)
        if self.retain > 1:
            self.backend.write(f"{self.name}-t{time}", blob)
            if time not in self._ring:
                self._ring.append(time)
            while len(self._ring) > self.retain:
                self.backend.write(f"{self.name}-t{self._ring.pop(0)}", b"")
        self._last_write = _time.monotonic()
        self.write_seconds.append(_time.perf_counter() - t0)
        self.write_bytes.append(len(blob))

    def on_commit(self, scope: Any, drivers: list, time: int) -> None:
        """Snapshot unless the last one is younger than the interval."""
        if self.interval and _time.monotonic() - self._last_write < self.interval:
            return
        self.snapshot(scope, drivers, time)

    # -- restore -------------------------------------------------------------

    def latest_time(self) -> int | None:
        """The commit time of the latest snapshot, without applying it."""
        raw = self.backend.read(self.name)
        if not raw:
            return None
        try:
            payload = pickle.loads(raw)
        except Exception:  # noqa: BLE001 — a truncated or corrupt snapshot: none
            return None
        return int(payload.get("time", 0))

    def restore(self, scope: Any, drivers: list, at_time: int | None = None) -> int | None:
        """Restore node and driver state; returns the snapshot's commit time when one
        was found and applied (the scheduler resumes after it, so sink times stay
        monotonic), else None.

        ``at_time`` picks a ring entry (``retain > 1``); the latest snapshot serves when
        it carries that time, and a time held by neither raises ``ValueError``."""
        t0 = _time.perf_counter()
        scopes = self._scopes_of(scope)
        raw = self.backend.read(self.name)
        if at_time is not None and raw:
            try:
                latest = int(pickle.loads(raw).get("time", 0))
            except Exception:  # noqa: BLE001 — a corrupt latest: read the ring entry
                latest = None
            if latest != at_time:
                raw = self.backend.read(f"{self.name}-t{at_time}")
        if not raw:
            if at_time is not None:
                raise ValueError(
                    f"no operator snapshot at commit time {at_time} under "
                    f"{self.name!r} (ring retains {self.retain})"
                )
            return None
        try:
            payload = pickle.loads(raw)
        except Exception:  # noqa: BLE001 — a truncated or corrupt snapshot: cold start
            return None
        fmt = payload.get("format", 1)
        if fmt != STATE_FORMAT:
            raise ValueError(
                f"operator snapshot has state format {fmt}; this build writes format "
                f"{STATE_FORMAT} (group-id salt change): restoring would resurrect state "
                "under stale keys — clear the persistence location or replay an input "
                "journal"
            )
        sigs, per_worker = payload["sigs"], payload["per_worker"]
        if [type(n).__name__ for n in scopes[0].nodes] != sigs[0]:
            raise ValueError(
                "operator snapshot does not match this graph (operator sequence changed "
                "— this includes toggling the graph optimizer, which fuses stateless "
                "chains into FusedChainNode; see PATHWAY_TPU_OPTIMIZE); clear the "
                "persistence location or use input-journal persistence across code "
                "changes"
            )
        want = list(getattr(scopes[0], "_pw_opt_fingerprint", []))
        got = list(payload.get("optimize", []))
        if want != got:
            raise ValueError(
                "operator snapshot was written under a different graph-optimizer plan "
                f"(snapshot applied {len(got)} rewrites, this run applies {len(want)}): "
                "restoring would load state into operators with a different column "
                "layout or fusion boundary — rerun with the same PATHWAY_TPU_OPTIMIZE "
                "setting, or clear the persistence location / replay an input journal"
            )
        if len(per_worker) != len(scopes):
            # another worker count: merge the old shards and split them again with the
            # sharded scheduler's routing
            per_worker = _reshard_worker_states(per_worker, scopes)
        else:
            for s, sig in zip(scopes, sigs):
                if [type(n).__name__ for n in s.nodes] != sig:
                    raise ValueError(
                        "operator snapshot does not match this graph (operator sequence "
                        "changed); clear the persistence location or use input-journal "
                        "persistence across code changes"
                    )
        for s, states in zip(scopes, per_worker):
            for node, state in zip(s.nodes, states):
                node.restore_op_state(state)
        for driver, state in zip(drivers, payload["drivers"]):
            self._restore_driver(driver, state)
        self.restore_seconds = _time.perf_counter() - t0
        self.restore_bytes = len(raw)
        return int(payload.get("time", 0))


def _reshard_worker_states(per_worker: list[list[dict]], scopes: list) -> list[list[dict]]:
    """Re-shard operator snapshots onto another worker count.

    Every node's state is merged over the old workers, then split along the routing the
    sharded scheduler applies to live batches (``engine/sharded.py::partitioner``):
    groupbys by grouping values, joins by join key, deduplicate by instance, pinned
    operators whole to worker 0, sources whole on worker 0 and by row key on the
    others, everything else by row key. A node whose other state has routing this
    cannot rebuild raises; input-journal persistence changes worker counts for those.
    A snapshot of one worker holds no input mirrors (an unsharded scope reads its
    inputs' ``current``), so the mirrors and the iterate's input states are rebuilt
    from the inputs' snapshot state, routed as the live batches would be. The states
    are the unpickled snapshot's plain dicts (its packed Pointer keys are dicts again
    once read)."""
    from pathway_tpu_torch.engine.graph import (
        DeduplicateNode,
        GroupbyNode,
        InputSession,
        JoinNode,
        StaticSource,
    )
    from pathway_tpu_torch.engine.sharded import _shard_of, partitioner

    n_new = len(scopes)
    # old worker 0 carried every node (its sink chains too), the others the shared
    # graph; the new side has the same layout
    nodes = scopes[0].nodes
    n_nodes = min(len(nodes), len(per_worker[0]))

    def merged_state(i: int) -> dict:
        """One node's state, merged over the old workers."""
        base = dict(per_worker[0][i])
        for states in per_worker[1:]:
            if i >= len(states):
                continue
            for attr, val in states[i].items():
                cur = base.get(attr)
                if isinstance(cur, dict) and isinstance(val, dict):
                    base[attr] = {**cur, **val}
                elif (
                    isinstance(cur, list)
                    and isinstance(val, list)
                    and len(cur) == len(val)
                    and all(isinstance(x, dict) for x in cur + val)
                ):
                    base[attr] = [{**a, **b} for a, b in zip(cur, val)]
                # scalars (watermarks, flags): worker 0's copy stands
        return base

    def empty_like(state: dict) -> dict:
        out = {}
        for attr, val in state.items():
            if isinstance(val, dict):
                out[attr] = {}
            elif isinstance(val, list) and all(isinstance(x, dict) for x in val):
                out[attr] = [{} for _ in val]
            else:
                out[attr] = val
        return out

    def split_dict(d: dict, route) -> list[dict]:
        parts: list[dict] = [{} for _ in range(n_new)]
        for key, val in d.items():
            parts[route(key, val)][key] = val
        return parts

    def by_key(key, _val) -> int:
        return _shard_of(key, n_new)

    position = {id(node): i for i, node in enumerate(nodes)}
    merged_states: list[dict] = []

    def routed_input(node, port: int) -> list[dict]:
        """The state ``node`` received on ``port``, split as the live batches are."""
        state = merged_states[position[id(node.inputs[port])]]["current"]
        route = partitioner(node, port, n_new)
        if route is None:  # pinned: worker 0 receives everything
            return [dict(state)] + [{} for _ in range(1, n_new)]
        return split_dict(state, route)

    out: list[list[dict]] = [[] for _ in range(n_new)]
    for i in range(n_nodes):
        node = nodes[i]
        merged = merged_state(i)
        merged_states.append(merged)
        shards = [empty_like(merged) for _ in range(n_new)]
        if isinstance(node, (StaticSource, InputSession)):
            # worker 0 keeps the whole source state, the others their key shards
            shards[0]["current"] = dict(merged["current"])
            for w in range(1, n_new):
                shards[w]["current"] = {
                    k: v for k, v in merged["current"].items() if _shard_of(k, n_new) == w
                }
        elif isinstance(node, GroupbyNode):
            groups = split_dict(
                merged["groups"], lambda _k, entry: _shard_of(tuple(entry[0]), n_new)
            )
            n_by = len(node.by_cols)
            current = split_dict(
                merged["current"], lambda _k, row: _shard_of(tuple(row[:n_by]), n_new)
            )
            for w in range(n_new):
                shards[w]["groups"] = groups[w]
                shards[w]["current"] = current[w]
        elif isinstance(node, JoinNode):
            for attr in ("left_arr", "right_arr"):
                parts = split_dict(merged[attr], lambda jk, _v: _shard_of(jk, n_new))
                for w in range(n_new):
                    shards[w][attr] = parts[w]
            lcols, rcols = node.left_on, node.right_on
            l_arity = node.inputs[0].arity

            def route_join_row(_k, row, lcols=lcols, rcols=rcols, l_arity=l_arity):
                jk = tuple(row[c] for c in lcols)
                if any(v is None for v in jk):
                    # an unmatched right row (right and outer joins) has a None left
                    # prefix: it lives where the right side's key routes it
                    jk = tuple(row[l_arity + c] for c in rcols)
                return _shard_of(jk, n_new)

            parts = split_dict(merged["current"], route_join_row)
            for w in range(n_new):
                shards[w]["current"] = parts[w]
        elif isinstance(node, DeduplicateNode):
            icols = node.instance_cols
            for attr in ("accepted", "current"):
                parts = split_dict(
                    merged[attr], lambda _k, row: _shard_of(tuple(row[c] for c in icols), n_new)
                )
                for w in range(n_new):
                    shards[w][attr] = parts[w]
        elif partitioner(node, 0, n_new) is None:
            # a pinned operator: old worker 0 received every batch and holds its whole
            # state, the others none (nor an external index's)
            shards[0] = dict(per_worker[0][i])
        else:
            # key-routed: ``current`` and the input mirrors split by row key; any other
            # populated state has routing this cannot rebuild
            for attr, val in merged.items():
                if attr in ("current", "_mirrors"):
                    continue
                if isinstance(val, (dict, list, set)) and val:
                    raise ValueError(
                        f"operator snapshot cannot be re-sharded: node "
                        f"{type(node).__name__} carries {attr!r} state with unknown "
                        f"routing; resume with the original worker count "
                        f"({len(per_worker)}) or use input-journal persistence "
                        "(PersistenceMode.PERSISTING) to change worker counts"
                    )
            parts = split_dict(merged["current"], by_key)
            for w in range(n_new):
                shards[w]["current"] = parts[w]
            if isinstance(merged.get("_mirrors"), list):
                mirror_parts = [split_dict(m, by_key) for m in merged["_mirrors"]]
                for w in range(n_new):
                    shards[w]["_mirrors"] = [mp[w] for mp in mirror_parts]
        if len(per_worker) == 1:
            for attr in ("_mirrors", "_input_states"):
                if isinstance(merged.get(attr), list):
                    parts = [routed_input(node, p) for p in range(len(node.inputs))]
                    for w in range(n_new):
                        shards[w][attr] = [part[w] for part in parts]
        for w in range(n_new):
            out[w].append(shards[w])
    return out


def reshard_process_snapshots(
    backend: PersistenceBackend,
    old_processes: int,
    new_processes: int,
    threads: int,
    scopes: list,
    *,
    n_shared: int,
) -> dict:
    """Rewrite the per-process operator snapshots of an N-process mesh for an
    M-process mesh (the state step of ``MeshSupervisor.rescale``).

    Every process of a quiesced mesh left ``operator-snapshot-p<pid>`` at the same
    commit. They are merged into the global list of worker states (global worker id =
    ``pid * threads + scope index``, the mesh's numbering), split again by
    :func:`_reshard_worker_states`, through the routing the live exchange uses, and
    written as one snapshot (and its ring entry) per new process. The snapshots of
    processes past the new count are blanked, so a later scale-out cannot resume from
    them. ``scopes`` are the calling process's own worker scopes (scope 0 whole, with
    the sink chain; the others up to ``n_shared``). Returns a report: the sizes, the
    commit time, the source rows and the count of keys that change owner
    (``engine/routing.py::reshard_moves``)."""
    from pathway_tpu_torch.engine.graph import InputSession, StaticSource
    from pathway_tpu_torch.engine.routing import reshard_moves

    if old_processes < 1 or new_processes < 1:
        raise ValueError("process counts must be >= 1")

    def _load(name: str) -> dict | None:
        raw = backend.read(name)
        if not raw:
            return None
        try:
            return pickle.loads(raw)
        except Exception:  # noqa: BLE001 — a truncated or corrupt snapshot: none
            return None

    payloads: list[dict] = []
    for p in range(old_processes):
        payload = _load(f"operator-snapshot-p{p}")
        if payload is None:
            raise ValueError(
                f"rescale: no operator snapshot for process {p} "
                f"(expected {old_processes} quiesced snapshots)"
            )
        payloads.append(payload)
    for p, payload in enumerate(payloads):
        fmt = payload.get("format", 1)
        if fmt != STATE_FORMAT:
            raise ValueError(
                f"rescale: process {p} snapshot has state format {fmt}; "
                f"this build writes format {STATE_FORMAT}"
            )
    t_common = min(int(pl.get("time", 0)) for pl in payloads)
    for p, payload in enumerate(payloads):
        if int(payload.get("time", 0)) != t_common:
            ring = _load(f"operator-snapshot-p{p}-t{t_common}")
            if ring is None:
                raise ValueError(
                    f"rescale: process {p} has no snapshot at the common commit "
                    f"time {t_common} (ring rotated?)"
                )
            payloads[p] = ring
    base = payloads[0]
    fp = list(base.get("optimize", []))
    for p, payload in enumerate(payloads[1:], start=1):
        if list(payload.get("optimize", [])) != fp:
            raise ValueError(
                f"rescale: process {p} snapshot was written under a different "
                "graph-optimizer plan than process 0"
            )
    if list(getattr(scopes[0], "_pw_opt_fingerprint", [])) != fp:
        raise ValueError(
            "rescale: snapshots were written under a different graph-optimizer plan "
            "than this process applies — rerun with the same PATHWAY_TPU_OPTIMIZE "
            "setting"
        )
    full_sig = [type(n).__name__ for n in scopes[0].nodes]
    if base["sigs"][0] != full_sig:
        raise ValueError(
            "rescale: operator snapshot does not match this graph (operator sequence "
            "changed); clear the persistence location instead of rescaling across "
            "code changes"
        )
    shared_sig = full_sig[:n_shared]
    for p, payload in enumerate(payloads[1:], start=1):
        if payload["sigs"][0][: len(shared_sig)] != shared_sig:
            raise ValueError(
                f"rescale: process {p} snapshot does not match the shared graph prefix"
            )

    global_per_worker: list[list[dict]] = []
    for payload in payloads:
        global_per_worker.extend(payload["per_worker"])
    virtual = [scopes[0]] * (new_processes * threads)
    new_per_worker = _reshard_worker_states(global_per_worker, virtual)

    # the volume moved: old worker 0 mirrors every source row, so its keys are the rows
    src_keys: list = []
    for i, node in enumerate(scopes[0].nodes[:n_shared]):
        if isinstance(node, (StaticSource, InputSession)) and i < len(global_per_worker[0]):
            cur = global_per_worker[0][i].get("current")
            if isinstance(cur, dict):
                src_keys.extend(cur.keys())
    moved = reshard_moves(src_keys, old_processes * threads, new_processes * threads)

    for q in range(new_processes):
        states = new_per_worker[q * threads:(q + 1) * threads]
        if q == 0:
            sigs = [[type(n).__name__ for n in s.nodes] for s in scopes]
            states = [states[0]] + [st[:n_shared] for st in states[1:]]
            drivers = base.get("drivers", [])
        else:
            sigs = [list(shared_sig) for _ in range(threads)]
            states = [st[:n_shared] for st in states]
            drivers = []
        blob = pickle.dumps(
            {
                "format": STATE_FORMAT,
                "sigs": sigs,
                "per_worker": states,
                "drivers": drivers,
                "time": t_common,
                "optimize": fp,
            },
            protocol=4,
        )
        backend.write(f"operator-snapshot-p{q}", blob)
        backend.write(f"operator-snapshot-p{q}-t{t_common}", blob)
    for q in range(new_processes, old_processes):
        backend.write(f"operator-snapshot-p{q}", b"")
    return {
        "old_processes": old_processes,
        "new_processes": new_processes,
        "threads": threads,
        "time": t_common,
        "source_rows": len(src_keys),
        "moved_keys": moved,
    }
