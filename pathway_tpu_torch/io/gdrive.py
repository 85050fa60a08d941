"""``pw.io.gdrive``: poll a Google Drive folder.

Counterpart of ``pathway_tpu/io/gdrive.py``: a Drive REST v3 poller speaking the
``files.list``, ``files.get?alt=media`` and ``files.export`` endpoints (the folder
traversed recursively, changes diffed on ``modifiedTime``, deleted or trashed files
retracted, Google Docs, Sheets and Slides exported to text, csv and pdf) over an
injectable ``http_fn(url, params, headers) -> bytes``. The default ``http_fn`` uses
urllib with a bearer token: ``access_token=``, or a service account's credentials file
(the JWT grant, signed RS256 with the ``cryptography`` package; without it, pass
``access_token=`` or ``http_fn=``).
"""

from __future__ import annotations

import json
import time as _time
import urllib.parse
import urllib.request
from typing import Any, Callable

from pathway_tpu_torch.engine.connectors import UPSERT, ParsedEvent, Parser, Reader
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table

DRIVE_API = "https://www.googleapis.com/drive/v3"

FOLDER_MIME = "application/vnd.google-apps.folder"

#: Google-native types have no binary content; they are exported
#: (reference gdrive connector's export behavior)
EXPORT_MIMES = {
    "application/vnd.google-apps.document": "text/plain",
    "application/vnd.google-apps.spreadsheet": "text/csv",
    "application/vnd.google-apps.presentation": "application/pdf",
}

_LIST_FIELDS = (
    "nextPageToken,files(id,name,mimeType,modifiedTime,size,trashed,parents)"
)


def _default_http_fn(token: str) -> Callable[[str, dict, dict], bytes]:
    def http_fn(url: str, params: dict, headers: dict) -> bytes:
        if params:
            url = url + "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {token}", **headers}
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    return http_fn


def _service_account_token(credentials_file: str) -> str:
    """OAuth2 JWT-bearer grant for a service account (drive.readonly)."""
    with open(credentials_file) as f:
        creds = json.load(f)
    try:
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "service-account auth needs the 'cryptography' package for "
            "RS256 signing; pass access_token= or http_fn= instead"
        ) from e
    import base64

    def b64(data: bytes) -> bytes:
        return base64.urlsafe_b64encode(data).rstrip(b"=")

    now = int(_time.time())
    header = b64(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    claims = b64(
        json.dumps(
            {
                "iss": creds["client_email"],
                "scope": "https://www.googleapis.com/auth/drive.readonly",
                "aud": "https://oauth2.googleapis.com/token",
                "iat": now,
                "exp": now + 3600,
            }
        ).encode()
    )
    signing_input = header + b"." + claims
    key = serialization.load_pem_private_key(
        creds["private_key"].encode(), password=None
    )
    signature = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    assertion = (signing_input + b"." + b64(signature)).decode()
    body = urllib.parse.urlencode(
        {
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": assertion,
        }
    ).encode()
    req = urllib.request.Request(
        "https://oauth2.googleapis.com/token", data=body, method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as resp:  # pragma: no cover
        return json.loads(resp.read().decode())["access_token"]


class GDriveClient:
    """Drive REST v3 subset: recursive listing + content download."""

    def __init__(
        self,
        http_fn: Callable[[str, dict, dict], bytes],
        api_base: str = DRIVE_API,
    ) -> None:
        self.http_fn = http_fn
        self.api_base = api_base.rstrip("/")

    def _get_json(self, path: str, params: dict) -> dict:
        return json.loads(
            self.http_fn(f"{self.api_base}{path}", params, {}).decode()
        )

    def list_folder(self, folder_id: str) -> list[dict]:
        """All non-trashed, non-folder files under ``folder_id``,
        recursively (folders are traversed, files collected)."""
        out: list[dict] = []
        pending = [folder_id]
        seen_folders = set()
        while pending:
            fid = pending.pop()
            if fid in seen_folders:
                continue  # cycles via multi-parent links
            seen_folders.add(fid)
            page_token: str | None = None
            while True:
                params: dict[str, Any] = {
                    "q": f"'{fid}' in parents and trashed = false",
                    "fields": _LIST_FIELDS,
                    "pageSize": 1000,
                }
                if page_token:
                    params["pageToken"] = page_token
                body = self._get_json("/files", params)
                for f in body.get("files", []):
                    if f.get("mimeType") == FOLDER_MIME:
                        pending.append(f["id"])
                    else:
                        out.append(f)
                page_token = body.get("nextPageToken")
                if not page_token:
                    break
        return out

    def download(self, file: dict) -> bytes:
        mime = file.get("mimeType", "")
        if mime in EXPORT_MIMES:
            return self.http_fn(
                f"{self.api_base}/files/{file['id']}/export",
                {"mimeType": EXPORT_MIMES[mime]},
                {},
            )
        return self.http_fn(
            f"{self.api_base}/files/{file['id']}", {"alt": "media"}, {}
        )


class _GDrivePollReader(Reader):
    """Poll a folder; upsert new/modified files (keyed by file id),
    retract vanished/trashed ones — the reference connector's diffing."""

    def __init__(
        self,
        client: Any,
        folder_id: str,
        mode: str,
        refresh_interval_s: float,
    ) -> None:
        self.client = client
        self.folder_id = folder_id
        self.mode = mode
        self.refresh_interval_s = refresh_interval_s
        #: file id -> modifiedTime version last ingested
        self._known: dict[str, str] = {}
        self._last_poll = 0.0
        self._first = True

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        now = _time.monotonic()
        if not self._first and now - self._last_poll < self.refresh_interval_s:
            return [], False
        self._last_poll = now
        self._first = False
        files = {f["id"]: f for f in self.client.list_folder(self.folder_id)}
        events: list[tuple[Any, str, dict]] = []
        for fid, meta in files.items():
            version = meta.get("modifiedTime", "")
            if self._known.get(fid) == version:
                continue
            data = self.client.download(meta)
            self._known[fid] = version
            events.append((("upsert", fid, data), fid, dict(meta)))
        for fid in list(self._known):
            if fid not in files:
                del self._known[fid]
                events.append((("delete", fid, None), fid, {"id": fid}))
        return events, self.mode == "static"

    def state(self) -> dict:
        return {"known": dict(self._known)}

    def restore_state(self, state: dict) -> None:
        # versions suffice: content re-downloads only for changed files
        self._known = dict(state.get("known", {}))


class _GDriveParser(Parser):
    session_type = "upsert"

    def __init__(self) -> None:
        super().__init__(["data"])

    def parse(self, payload: Any) -> list[ParsedEvent]:
        kind, fid, data = payload
        if kind == "delete":
            return [ParsedEvent(UPSERT, None, key=(fid,))]
        return [ParsedEvent(UPSERT, (data,), key=(fid,))]


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    service_user_credentials_file: str | None = None,
    access_token: str | None = None,
    http_fn: Callable[[str, dict, dict], bytes] | None = None,
    api_base: str = DRIVE_API,
    refresh_interval: float = 30.0,
    with_metadata: bool = False,
    service: Any = None,
    **kwargs: Any,
) -> Table:
    """Each Drive file becomes one binary ``data`` row keyed by file id;
    edits replace the previous row, deletions/trash retract it. Google
    Docs/Sheets/Slides are exported (text/csv/pdf).

    Auth, in priority order: ``http_fn=`` (full transport override),
    ``access_token=``, or ``service_user_credentials_file=``
    (service-account JWT grant). The legacy ``service=`` seam
    (``list_files``/``download``) keeps working."""
    if service is not None:
        # legacy injectable seam, kept for compatibility
        class _SeamClient:
            def list_folder(self, folder_id: str) -> list[dict]:
                return [
                    {"id": fid, "modifiedTime": str(ver), "name": fid}
                    for fid, ver in service.list_files(folder_id)
                ]

            def download(self, file: dict) -> bytes:
                return service.download(file["id"])

        client: Any = _SeamClient()
    else:
        if http_fn is None:
            if access_token is not None:
                http_fn = _default_http_fn(access_token)
            elif service_user_credentials_file is None:
                raise ValueError(
                    "pw.io.gdrive.read needs one of http_fn=, "
                    "access_token= or service_user_credentials_file="
                )
            else:
                # service-account tokens expire after ~1h: re-mint with
                # headroom so a long streaming read never 401s mid-poll
                creds_file = service_user_credentials_file
                token_state = {"token": None, "exp": 0.0}

                def http_fn(url: str, params: dict, headers: dict) -> bytes:
                    now = _time.time()
                    if token_state["token"] is None or now > token_state["exp"]:
                        token_state["token"] = _service_account_token(
                            creds_file
                        )
                        token_state["exp"] = now + 3600 - 300
                    return _default_http_fn(token_state["token"])(
                        url, params, headers
                    )

        client = GDriveClient(http_fn, api_base=api_base)

    schema = schema_mod.schema_from_types(data=bytes)
    return input_table(
        schema,
        lambda: _GDrivePollReader(client, object_id, mode, refresh_interval),
        lambda names: _GDriveParser(),
        source_name=f"gdrive:{object_id}",
        with_metadata=with_metadata,
    )
