"""``pw.io``: the python connector and subscribe. The other connectors are not ported
yet (ROADMAP queue 1 item 15)."""

from pathway_tpu_torch.io import python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["python", "subscribe"]
