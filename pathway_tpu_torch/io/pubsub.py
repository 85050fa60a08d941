"""``pw.io.pubsub``: publish a table's update stream to Google Pub/Sub.

Counterpart of ``pathway_tpu/io/pubsub.py``: :class:`RestPublisher` speaks the
``topics.publish`` REST endpoint (``POST {base}/v1/projects/{p}/topics/{t}:publish``, the
message data base64-encoded) through ``io/_utils.py``'s ``post_json`` or an injected
``http_fn``; an injected ``publisher=`` (``publish(topic, data, **attrs)``) takes its
place, and with neither, google-cloud-pubsub's client is used where it imports."""

from __future__ import annotations

import base64 as _base64
import json
from typing import Any, Callable

from pathway_tpu_torch.engine.connectors import JsonLinesFormatter
from pathway_tpu_torch.engine.value import Pointer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, require

PUBSUB_API = "https://pubsub.googleapis.com"


class RestPublisher:
    """Speaks the Pub/Sub ``topics.publish`` REST endpoint."""

    def __init__(
        self,
        project_id: str,
        api_base: str = PUBSUB_API,
        access_token: str | None = None,
        http_fn: Callable[[str, dict], dict] | None = None,
    ) -> None:
        self.project_id = project_id
        self.api_base = api_base.rstrip("/")
        if http_fn is None:
            from pathway_tpu_torch.io._utils import post_json

            def http_fn(url: str, payload: dict) -> dict:
                return post_json(url, payload, token=access_token)

        self.http_fn = http_fn

    def publish(self, topic: str, data: bytes, **attrs: Any) -> str:
        url = (
            f"{self.api_base}/v1/projects/{self.project_id}/topics/"
            f"{topic}:publish"
        )
        message: dict[str, Any] = {
            "data": _base64.b64encode(data).decode()
        }
        if attrs:
            message["attributes"] = {k: str(v) for k, v in attrs.items()}
        body = self.http_fn(url, {"messages": [message]})
        ids = body.get("messageIds") or [""]
        return ids[0]


class _PubSubWriter:
    def __init__(self, publisher: Any, topic: str, column_names):
        self.publisher = publisher
        self.topic = topic
        self.formatter = JsonLinesFormatter()
        self.column_names = list(column_names)

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        payload = self.formatter.format(
            key, values, self.column_names, time, diff
        )
        self.publisher.publish(self.topic, payload.encode("utf-8"))

    def on_time_end(self, time: int) -> None:
        pass

    def on_end(self) -> None:
        pass


def write(
    table: Table,
    publisher: Any = None,
    project_id: str | None = None,
    topic_id: str | None = None,
    *,
    access_token: str | None = None,
    api_base: str | None = None,
    **kwargs: Any,
) -> None:
    """Publish the update log. Publisher resolution: explicit
    ``publisher=`` seam; else the built-in REST publisher when
    ``api_base=`` or ``access_token=`` is given; else
    google-cloud-pubsub."""
    if publisher is None and project_id is not None and (
        api_base is not None or access_token is not None
    ):
        publisher = RestPublisher(
            project_id,
            api_base=api_base or PUBSUB_API,
            access_token=access_token,
        )
    if publisher is None:
        pubsub = require("google.cloud.pubsub_v1", "pw.io.pubsub")
        client = pubsub.PublisherClient()
        topic = client.topic_path(project_id, topic_id)

        class _Adapter:
            def publish(self, _topic, data: bytes, **attrs):
                client.publish(topic, data, **attrs).result()

        publisher = _Adapter()
    topic = topic_id or ""

    def make_writer(column_names):
        return _PubSubWriter(publisher, topic, column_names)

    attach_writer(table, make_writer)
