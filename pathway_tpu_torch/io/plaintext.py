"""``pw.io.plaintext``: a row a non-blank line of the files under ``path``, in one
``data`` column (counterpart of ``pathway_tpu/io/plaintext.py``)."""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


def read(path: str | os.PathLike, *, mode: str = "streaming", with_metadata: bool = False, **kwargs: Any) -> Table:
    return _fs.read(path, format="plaintext", mode=mode, with_metadata=with_metadata, **kwargs)
