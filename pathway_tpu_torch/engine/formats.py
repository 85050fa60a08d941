"""Change-data-capture parsers and database formatters.

Counterpart of ``pathway_tpu/engine/formats.py``:

- :class:`DebeziumParser` reads Debezium's envelopes: from Postgres, ``r`` and ``c``
  insert the ``after`` image, ``u`` deletes ``before`` and inserts ``after``, ``d``
  deletes ``before`` (a native session); from MongoDB, whose change events lack the
  prior state, ``r``, ``c`` and ``u`` upsert ``after`` and ``d`` deletes the key (an
  upsert session). A payload is a Kafka ``(key, value)`` pair or one
  ``key<separator>value`` line; a null value (a tombstone) gives nothing.
- :class:`PsqlUpdatesFormatter` turns every change into an ``INSERT`` of the values,
  ``time`` and ``diff`` (an append-only update log); :class:`PsqlSnapshotFormatter`
  keeps the output table a snapshot (``INSERT ... ON CONFLICT (keys) DO UPDATE`` for an
  insertion, ``DELETE`` by key for a deletion); both give ``(statement, $n-params)``.
- :class:`DocumentFormatter` turns a row into a plain dict with ``time`` and ``diff``,
  for the document stores' writers.
"""

from __future__ import annotations

import json as _json
from typing import Any, Sequence

from pathway_tpu_torch.engine.connectors import (
    DELETE,
    INSERT,
    UPSERT,
    ParsedEvent,
    Parser,
)
from pathway_tpu_torch.engine.value import Json, Pointer

DEBEZIUM_EMPTY_KEY = "{}"


def _coerce_json(v: Any) -> Any:
    return Json(v) if isinstance(v, (dict, list)) else v


def _values_from_json(obj: Any, field_names: Sequence[str]) -> tuple:
    if not isinstance(obj, dict):
        raise ValueError(f"debezium: expected JSON object, got {obj!r}")
    return tuple(_coerce_json(obj.get(name)) for name in field_names)


class DebeziumParser(Parser):
    """Debezium's change envelopes -> events.

    A payload is a ``(key_bytes, value_bytes)`` pair (a Kafka record) or one line
    ``key<separator>value`` (a file). Operations:

    - postgres: ``r``/``c`` -> insert(after); ``u`` -> delete(before) +
      insert(after); ``d`` -> delete(before). Native session.
    - mongodb: ``r``/``c``/``u`` -> upsert(after); ``d`` -> upsert(key,
      None). Upsert session (Mongo change events lack the prior state).

    The row's key is the key payload's primary-key fields, when they are given.
    """

    def __init__(
        self,
        value_field_names: Sequence[str],
        key_field_names: Sequence[str] | None = None,
        db_type: str = "postgres",
        separator: str = "\t",
    ) -> None:
        super().__init__(value_field_names)
        if db_type not in ("postgres", "mongodb"):
            raise ValueError(f"unknown debezium db_type {db_type!r}")
        self.key_field_names = list(key_field_names) if key_field_names else None
        self.db_type = db_type
        self.separator = separator
        self.session_type = "native" if db_type == "postgres" else "upsert"

    def _key_of(self, key_payload: Any) -> tuple | None:
        if self.key_field_names is None:
            return None
        return _values_from_json(key_payload, self.key_field_names)

    def parse(self, payload: Any) -> list[ParsedEvent]:
        if isinstance(payload, tuple):
            raw_key, raw_value = payload
        else:
            if isinstance(payload, bytes):
                payload = payload.decode("utf-8")
            parts = payload.strip().split(self.separator)
            if len(parts) != 2:
                raise ValueError(
                    f"debezium: expected key{self.separator!r}value, got "
                    f"{len(parts)} tokens"
                )
            raw_key, raw_value = parts
        if isinstance(raw_key, bytes):
            raw_key = raw_key.decode("utf-8")
        if isinstance(raw_value, bytes):
            raw_value = raw_value.decode("utf-8")
        if raw_key is None:
            if self.key_field_names is not None:
                raise ValueError("debezium: empty kafka key payload")
            raw_key = DEBEZIUM_EMPTY_KEY
        if raw_value is None:
            return []  # kafka tombstone

        value_change = _json.loads(raw_value)
        if value_change is None:
            return []  # tombstone event
        if not isinstance(value_change, dict) or "payload" not in value_change:
            raise ValueError("debezium: no payload at the top level")
        change = value_change["payload"]
        key_change = _json.loads(raw_key)
        key_payload = (
            key_change.get("payload") if isinstance(key_change, dict) else None
        )
        key = self._key_of(key_payload)

        op = change.get("op")
        events: list[ParsedEvent] = []
        if op in ("r", "c"):
            after = _values_from_json(change.get("after"), self.column_names)
            kind = INSERT if self.db_type == "postgres" else UPSERT
            events.append(ParsedEvent(kind, after, key=key))
        elif op == "u":
            if self.db_type == "postgres":
                before = _values_from_json(
                    change.get("before"), self.column_names
                )
                after = _values_from_json(change.get("after"), self.column_names)
                events.append(ParsedEvent(DELETE, before, key=key))
                events.append(ParsedEvent(INSERT, after, key=key))
            else:
                after = _values_from_json(change.get("after"), self.column_names)
                events.append(ParsedEvent(UPSERT, after, key=key))
        elif op == "d":
            if self.db_type == "postgres":
                before = _values_from_json(
                    change.get("before"), self.column_names
                )
                events.append(ParsedEvent(DELETE, before, key=key))
            else:
                events.append(ParsedEvent(UPSERT, None, key=key))
        else:
            raise ValueError(f"debezium: unsupported operation {op!r}")
        return events


# -- SQL statement formatters -------------------------------------------------


def _sql_value(v: Any) -> Any:
    if isinstance(v, Json):
        return _json.dumps(v.value)
    if isinstance(v, Pointer):
        return repr(v)
    return v


class PsqlUpdatesFormatter:
    """Append-only update log: every change becomes an INSERT carrying
    (values..., time, diff). ``format`` returns (statement, params)."""

    def __init__(self, table_name: str, value_field_names: Sequence[str]) -> None:
        self.table_name = table_name
        self.value_field_names = list(value_field_names)

    def format(
        self, key: Pointer, values: tuple, time: int, diff: int
    ) -> tuple[str, list]:
        if len(values) != len(self.value_field_names):
            raise ValueError("column/value count mismatch")
        placeholders = ",".join(
            f"${i}" for i in range(1, len(values) + 1)
        )
        stmt = (
            f"INSERT INTO {self.table_name} "
            f"({','.join(self.value_field_names)},time,diff) "
            f"VALUES ({placeholders},{time},{diff})"
        )
        return stmt, [_sql_value(v) for v in values]


class PsqlSnapshotFormatter:
    """Maintain the output table as a snapshot: inserts become upserts
    (INSERT ... ON CONFLICT (keys) DO UPDATE), deletions become DELETEs by
    key."""

    def __init__(
        self,
        table_name: str,
        key_field_names: Sequence[str],
        value_field_names: Sequence[str],
    ) -> None:
        positions: dict[str, int] = {}
        for idx, name in enumerate(value_field_names):
            if name in positions:
                raise ValueError(f"repeated value field {name!r}")
            positions[name] = idx
        self.key_field_positions: list[int] = []
        for name in key_field_names:
            if name not in positions:
                raise ValueError(f"unknown key field {name!r}")
            self.key_field_positions.append(positions.pop(name))
        self.value_field_positions = sorted(positions.values())
        self.key_field_positions.sort()
        self.table_name = table_name
        self.key_field_names = list(key_field_names)
        self.value_field_names = list(value_field_names)

    def format(
        self, key: Pointer, values: tuple, time: int, diff: int
    ) -> tuple[str, list]:
        if len(values) != len(self.value_field_names):
            raise ValueError("column/value count mismatch")
        if diff > 0:
            placeholders = ",".join(
                f"${i}" for i in range(1, len(values) + 1)
            )
            set_items = [
                f"{self.value_field_names[p]}=${p + 1}"
                for p in self.value_field_positions
            ] + [f"time={time}", f"diff={diff}"]
            condition = " AND ".join(
                f"{self.table_name}.{self.value_field_names[p]}=${p + 1}"
                for p in self.key_field_positions
            )
            stmt = (
                f"INSERT INTO {self.table_name} "
                f"({','.join(self.value_field_names)},time,diff) "
                f"VALUES ({placeholders},{time},{diff}) "
                f"ON CONFLICT ({','.join(self.key_field_names)}) "
                f"DO UPDATE SET {','.join(set_items)} "
                f"WHERE {condition}"
            )
            return stmt, [_sql_value(v) for v in values]
        params = [
            _sql_value(values[p]) for p in self.key_field_positions
        ]
        condition = " AND ".join(
            f"{self.value_field_names[p]}=${i + 1}"
            for i, p in enumerate(self.key_field_positions)
        )
        return f"DELETE FROM {self.table_name} WHERE {condition}", params


class DocumentFormatter:
    """Row -> plain-dict document with ``time`` and ``diff`` fields, for the
    MongoDB and Elasticsearch writers (the injected client encodes it for the
    wire)."""

    def __init__(self, value_field_names: Sequence[str]) -> None:
        self.value_field_names = list(value_field_names)

    def format(self, key: Pointer, values: tuple, time: int, diff: int) -> dict:
        doc = {}
        for name, v in zip(self.value_field_names, values):
            if isinstance(v, Json):
                v = v.value
            elif isinstance(v, Pointer):
                v = repr(v)
            doc[name] = v
        doc["time"] = time
        doc["diff"] = diff
        return doc
