"""``pw.io.slack``: the first column of every inserted row posted as a Slack message.

Counterpart of ``pathway_tpu/io/slack.py``: one ``chat.postMessage`` a row insertion
(an alert is sent once: retractions send nothing), over ``requests`` or an injected
``post_fn(url, headers, payload)``."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.value import Json, Pointer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer

_SLACK_URL = "https://slack.com/api/chat.postMessage"


class _SlackWriter:
    def __init__(
        self,
        channel: str,
        token: str,
        column_names,
        post_fn: Callable[[str, dict, dict], Any] | None,
    ) -> None:
        self.channel = channel
        self.token = token
        self.column_names = list(column_names)
        if post_fn is None:
            import requests

            post_fn = lambda url, headers, payload: requests.post(  # noqa: E731
                url, headers=headers, json=payload, timeout=30
            ).raise_for_status()
        self.post_fn = post_fn

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        if diff <= 0:
            return  # alerts are fire-once; retractions are not re-sent
        v = values[0]
        text = str(v.value if isinstance(v, Json) else v)
        self.post_fn(
            _SLACK_URL,
            {"Authorization": f"Bearer {self.token}"},
            {"channel": self.channel, "text": text},
        )

    def on_time_end(self, time: int) -> None:
        pass

    def on_end(self) -> None:
        pass


def send_alerts(
    alerts: Table,
    slack_channel_id: str,
    slack_token: str,
    *,
    post_fn: Callable[[str, dict, dict], Any] | None = None,
) -> None:
    """Post the first column of every inserted row as a message."""

    def make_writer(column_names):
        return _SlackWriter(slack_channel_id, slack_token, column_names, post_fn)

    attach_writer(alerts, make_writer)
