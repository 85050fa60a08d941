"""``pw.io.airbyte``: Airbyte source connectors, run as local executables.

Counterpart of ``pathway_tpu/io/airbyte.py``. :class:`ExecutableAirbyteSource` runs a
command that speaks the Airbyte protocol on its standard output (``spec``, ``check``,
``discover`` and ``read``, with ``--config``, ``--catalog`` and ``--state`` files
written to a temporary directory; JSON lines of ``RECORD``, ``STATE``, ``CATALOG`` and
``CONNECTION_STATUS`` messages, other lines skipped); each call is one subprocess, waited
for and reaped before the call returns. :func:`read` gives one JSON ``data`` column a
record. An incremental stream hands the last sync's STATE to the next sync (and keeps
it through persistence's ``persistent_id``); a full-refresh stream's sync replaces the
last sync's rows. ``execution_type="venv"`` installs ``airbyte-<name>`` into a
virtualenv with pip (:func:`venv_connector_command`), which needs a package index or
the offline options it names; Docker and Cloud Run raise ``NotImplementedError``.
:func:`read_records` replays captured records as a static table.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time as _time
from typing import Any, Iterable, Sequence

from pathway_tpu_torch.engine.connectors import INSERT, ParsedEvent, Parser, Reader
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table

FULL_REFRESH_SYNC_MODE = "full_refresh"
INCREMENTAL_SYNC_MODE = "incremental"


class ExecutableAirbyteSource:
    """Drive a local Airbyte-protocol source executable.

    ``command`` is the argv prefix (e.g. ``["python", "-m", "source_faker"]``
    or a console-script path); protocol subcommands and ``--config`` /
    ``--catalog`` / ``--state`` files are appended per call.
    """

    def __init__(
        self,
        command: Sequence[str],
        config: dict | None,
        streams: Sequence[str],
        env_vars: dict[str, str] | None = None,
    ) -> None:
        self.command = list(command)
        self.config = config or {}
        self.streams = list(streams)
        self.env_vars = dict(env_vars or {})
        self._catalog: dict | None = None

    def _run(self, args: list[str]) -> list[dict]:
        env = {**os.environ, **self.env_vars}
        proc = subprocess.run(
            self.command + args,
            capture_output=True,
            text=True,
            env=env,
            timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"airbyte source {self.command} {args[0]} failed "
                f"(rc={proc.returncode}): {proc.stderr[-2000:]}"
            )
        messages = []
        for line in proc.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                messages.append(json.loads(line))
            except ValueError:
                continue  # connectors may log non-JSON lines to stdout
        return messages

    def _with_config(self, extra: list[str]) -> list[dict]:
        with tempfile.TemporaryDirectory(prefix="pw-airbyte-") as tmp:
            config_path = os.path.join(tmp, "config.json")
            with open(config_path, "w") as f:
                json.dump(self.config, f)
            resolved = [a.replace("{config}", config_path) for a in extra]
            return self._run(resolved)

    def spec(self) -> dict:
        for msg in self._run(["spec"]):
            if msg.get("type") == "SPEC":
                return msg["spec"]
        raise RuntimeError("source emitted no SPEC message")

    def check(self) -> bool:
        for msg in self._with_config(["check", "--config", "{config}"]):
            if msg.get("type") == "CONNECTION_STATUS":
                return msg["connectionStatus"]["status"] == "SUCCEEDED"
        raise RuntimeError("source emitted no CONNECTION_STATUS message")

    def discover(self) -> dict:
        if self._catalog is None:
            for msg in self._with_config(
                ["discover", "--config", "{config}"]
            ):
                if msg.get("type") == "CATALOG":
                    self._catalog = msg["catalog"]
                    break
            else:
                raise RuntimeError("source emitted no CATALOG message")
        return self._catalog

    @property
    def configured_catalog(self) -> dict:
        catalog = self.discover()
        by_name = {s["name"]: s for s in catalog.get("streams", [])}
        configured = []
        for name in self.streams:
            stream = by_name.get(name)
            if stream is None:
                raise ValueError(
                    f"stream {name!r} not in the source catalog "
                    f"(available: {sorted(by_name)})"
                )
            supported = stream.get("supported_sync_modes") or [
                FULL_REFRESH_SYNC_MODE
            ]
            sync_mode = (
                INCREMENTAL_SYNC_MODE
                if INCREMENTAL_SYNC_MODE in supported
                else FULL_REFRESH_SYNC_MODE
            )
            configured.append(
                {
                    "stream": stream,
                    "sync_mode": sync_mode,
                    "destination_sync_mode": "append",
                }
            )
        return {"streams": configured}

    def extract(
        self, state: list | dict | None = None
    ) -> tuple[list[dict], Any]:
        """One sync: ``(records, final_state)`` for the configured
        streams; ``state`` resumes an incremental sync."""
        with tempfile.TemporaryDirectory(prefix="pw-airbyte-") as tmp:
            config_path = os.path.join(tmp, "config.json")
            catalog_path = os.path.join(tmp, "catalog.json")
            with open(config_path, "w") as f:
                json.dump(self.config, f)
            with open(catalog_path, "w") as f:
                json.dump(self.configured_catalog, f)
            args = [
                "read",
                "--config",
                config_path,
                "--catalog",
                catalog_path,
            ]
            if state is not None:
                state_path = os.path.join(tmp, "state.json")
                with open(state_path, "w") as f:
                    json.dump(state, f)
                args += ["--state", state_path]
            wanted = set(self.streams)
            records: list[dict] = []
            # per-stream STATE messages accumulate (last wins per stream);
            # a single legacy data blob passes through as-is — overwriting
            # with only the last message would lose every other stream's
            # cursor between syncs
            stream_states: dict[str, dict] = {}
            legacy_state: Any = None
            for msg in self._run(args):
                if msg.get("type") == "RECORD":
                    record = msg["record"]
                    if record.get("stream") in wanted:
                        records.append(record)
                elif msg.get("type") == "STATE":
                    st = msg["state"]
                    if st.get("type") == "STREAM" and "stream" in st:
                        desc = json.dumps(
                            st["stream"].get("stream_descriptor", {}),
                            sort_keys=True,
                        )
                        stream_states[desc] = st
                    else:
                        legacy_state = st.get("data", st)
            if stream_states:
                final_state: Any = list(stream_states.values())
            elif legacy_state is not None:
                final_state = legacy_state
            else:
                final_state = state
            return records, final_state


class _AirbyteReader(Reader):
    """Poll the source; incremental syncs append with carried STATE,
    full-refresh syncs replace the previous sync's rows. Sync modes are
    homogeneous per read() — the reference enforces the same rule."""

    def __init__(
        self,
        source: ExecutableAirbyteSource,
        mode: str,
        refresh_interval_s: float,
    ) -> None:
        self.source = source
        self.mode = mode
        self.refresh_interval_s = refresh_interval_s
        self._state: Any = None
        self._last_sync = 0.0
        self._first = True
        modes = {
            s["sync_mode"]
            for s in source.configured_catalog["streams"]
        }
        if len(modes) > 1:
            # mixed modes cannot share one reader: full-refresh streams
            # must replace their previous sync while incremental ones
            # append (reference io/airbyte/__init__.py raises identically)
            raise ValueError(
                "all streams within one pw.io.airbyte.read must share a "
                f"sync_mode; got {sorted(modes)} — split into one read() "
                "per mode"
            )
        self._incremental = modes == {INCREMENTAL_SYNC_MODE}
        # full-refresh polls re-read the same source: later syncs replace.
        # Each stream's WHOLE sync is one payload (one source id), so the
        # replacement unit is the stream snapshot, not a single record.
        self.replaces_sources = not self._incremental

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        now = _time.monotonic()
        if not self._first and now - self._last_sync < self.refresh_interval_s:
            return [], False
        self._last_sync = now
        self._first = False
        records, self._state = self.source.extract(
            self._state if self._incremental else None
        )
        # seed EVERY configured stream: a full-refresh sync that returns
        # zero records must still emit an empty replacing payload so the
        # previous snapshot's rows retract
        by_stream: dict[str, list[dict]] = {
            s["stream"]["name"]: []
            for s in self.source.configured_catalog["streams"]
        }
        for record in records:
            by_stream.setdefault(record.get("stream", ""), []).append(record)
        entries = [
            (recs, f"airbyte:{stream}", {"stream": stream})
            for stream, recs in by_stream.items()
            if recs or not self._incremental
        ]
        return entries, self.mode == "static"

    def state(self) -> dict:
        return {"airbyte_state": self._state}

    def restore_state(self, state: dict) -> None:
        self._state = state.get("airbyte_state")


class _AirbyteParser(Parser):
    def __init__(self) -> None:
        super().__init__(["data"])

    def parse(self, payload: Any) -> list[ParsedEvent]:
        from pathway_tpu_torch.engine.value import Json

        return [
            ParsedEvent(INSERT, (Json(record.get("data", {})),))
            for record in payload
        ]


def _load_config(config_file_path: str) -> tuple[dict, list[str] | None]:
    """(source config, optional command from the file). Accepts the
    airbyte-serverless YAML layout (``source: {config:, exec:}``) and
    plain JSON/YAML config objects."""
    with open(config_file_path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml

        doc = yaml.safe_load(text)
    if not isinstance(doc, dict):
        raise ValueError("airbyte config file must hold an object")
    source = doc.get("source")
    if isinstance(source, dict):
        command = source.get("exec")
        if isinstance(command, str):
            command = command.split()
        return source.get("config") or {}, command
    return doc, None


def venv_connector_command(
    connector_name: str,
    *,
    venv_path: str | None = None,
    pip_extra_args: Sequence[str] | None = None,
    reuse: bool = True,
) -> list[str]:
    """Create a virtualenv, pip-install ``airbyte-<name>``, and return
    the connector's entry-point argv (reference VenvAirbyteSource,
    third_party/airbyte_serverless/sources.py:137-170).

    pip needs a package index; this environment may be OFFLINE. The
    offline paths, all first-class:

    - ``venv_path=`` pointing at a venv where the connector entry point
      already exists (``reuse=True`` skips pip entirely);
    - ``pip_extra_args=["--no-index", "--find-links", <wheel dir>]``
      installing from local wheels;
    - or skip this helper and pass ``connector_command=`` naming any
      local Airbyte-protocol executable.
    """
    import os
    import pathlib
    import subprocess
    import tempfile
    import venv as venv_mod

    name = connector_name.removeprefix("airbyte-")
    root = pathlib.Path(
        venv_path
        if venv_path is not None
        else tempfile.mkdtemp(prefix=f"pw-airbyte-{name}-")
    )
    exe = root / "bin" / name
    if reuse and exe.exists():
        return [os.fspath(exe)]
    if not (root / "bin" / "pip").exists():
        venv_mod.create(root, with_pip=True)
    cmd = [
        os.fspath(root / "bin" / "pip"),
        "install",
        *(pip_extra_args or ()),
        f"airbyte-{name}",
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=600
        )
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(
            f"pip install airbyte-{name} timed out after 600s — this "
            f"environment likely has no network access. Offline options: "
            f"pip_extra_args=['--no-index', '--find-links', '<wheel "
            f"dir>'], venv_path= at a venv with the connector already "
            f"installed, or connector_command= naming a local "
            f"Airbyte-protocol executable."
        ) from exc
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr)[-2000:]
        raise RuntimeError(
            f"failed to install airbyte-{name} into {root} (pip exited "
            f"{proc.returncode}).\n--- pip output (tail) ---\n{tail}\n"
            f"If PyPI is unreachable from this environment, use one of "
            f"the offline options: pip_extra_args=['--no-index', "
            f"'--find-links', '<dir with wheels>'], venv_path= at a "
            f"venv where the connector is already installed, or "
            f"connector_command= naming a local Airbyte-protocol "
            f"executable."
        )
    if not exe.exists():
        raise RuntimeError(
            f"airbyte-{name} installed but its entry point {exe} is "
            f"missing; pass connector_command= explicitly"
        )
    return [os.fspath(exe)]


def read(
    config_file_path: str,
    streams: Sequence[str],
    *,
    mode: str = "streaming",
    execution_type: str = "local",
    connector_command: Sequence[str] | str | None = None,
    env_vars: dict[str, str] | None = None,
    refresh_interval_ms: int = 60000,
    persistent_id: str | None = None,
    connector_name: str | None = None,
    venv_path: str | None = None,
    pip_extra_args: Sequence[str] | None = None,
    **kwargs: Any,
) -> Table:
    """Run a local Airbyte source and stream its records (one JSON
    ``data`` column per record — the reference's _AirbyteRecordSchema).

    ``execution_type="local"``: ``connector_command`` names the
    executable (argv list or shell-split string); it may also come from
    the config file's ``source.exec`` field.
    ``execution_type="venv"`` (the reference's pypi method): a
    virtualenv is created and ``airbyte-<connector_name>`` installed
    into it via :func:`venv_connector_command` — with explicit offline
    fallbacks (pre-installed ``venv_path=``, local-wheel
    ``pip_extra_args=``). Docker/Cloud-Run execution stays unavailable
    in this environment."""
    if execution_type not in ("local", "venv", "pypi"):
        raise NotImplementedError(
            f"execution_type={execution_type!r}: 'local' executables and "
            "'venv' (pip-installed connectors) are supported here (no "
            "docker/Cloud Run runtime)"
        )
    config, file_command = _load_config(config_file_path)
    if execution_type in ("venv", "pypi"):
        if connector_name is None:
            raise ValueError(
                "execution_type='venv' needs connector_name= (e.g. "
                "'source-faker')"
            )
        connector_command = venv_connector_command(
            connector_name,
            venv_path=venv_path,
            pip_extra_args=pip_extra_args,
        )
    if connector_command is None:
        connector_command = file_command
    if connector_command is None:
        raise ValueError(
            "no connector command: pass connector_command= or put "
            "'source: {exec: ...}' in the config file"
        )
    if isinstance(connector_command, str):
        connector_command = connector_command.split()
    source = ExecutableAirbyteSource(
        connector_command, config, streams, env_vars=env_vars
    )
    schema = schema_mod.schema_from_types(data=dict)

    return input_table(
        schema,
        lambda: _AirbyteReader(source, mode, refresh_interval_ms / 1000.0),
        lambda names: _AirbyteParser(),
        source_name=f"airbyte:{','.join(streams)}",
        persistent_id=persistent_id,
    )


def read_records(records: Iterable[dict], stream: str = "stream") -> Table:
    """Replay a captured Airbyte record stream (each record a dict with the
    stream's fields) as a static table."""
    import pathway_tpu_torch as pw

    records = [r for r in records]
    if not records:
        raise ValueError("no records")
    names = sorted({k for r in records for k in r})
    schema = schema_mod.schema_from_types(**{n: Any for n in names})
    rows = [tuple(r.get(n) for n in names) for r in records]
    return pw.debug.table_from_rows(schema, rows)
