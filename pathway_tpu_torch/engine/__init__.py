"""The as-of-now KNN index on the card and its host twin."""

from pathway_tpu_torch.engine.external_index import DeviceKnnIndex, HostKnnIndex

__all__ = ["DeviceKnnIndex", "HostKnnIndex"]
