"""``pw.io.s3_csv``: ``pw.io.s3.read`` in the csv format (counterpart of
``pathway_tpu/io/s3_csv.py``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import s3 as _s3


def read(path: str, **kwargs: Any):
    kwargs.setdefault("format", "csv")
    return _s3.read(path, **kwargs)
