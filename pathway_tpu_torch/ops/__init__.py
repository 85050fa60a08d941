"""Device operators: the flash-attention kernel and the KNN index's operators.

The function ``flash_attention`` is not re-exported here, so that
``pathway_tpu_torch.ops.flash_attention`` stays the module."""

from pathway_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from pathway_tpu_torch.ops.knn import (
    METRICS,
    DeviceKnnState,
    knn_init,
    knn_search,
    knn_update,
)

__all__ = [
    "METRICS",
    "DeviceKnnState",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "knn_init",
    "knn_search",
    "knn_update",
]
