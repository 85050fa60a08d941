"""License keys and their entitlements.

Counterpart of ``pathway_tpu/internals/license.py``. A key is self-describing,
``pathway-tpu:<entitlement>[,<entitlement>...]`` (for example
``pathway-tpu:unlimited-workers,xpack-sharepoint``), and comes from
``PATHWAY_LICENSE_KEY`` or ``pw.set_license_key``. No key is the free tier: everything
runs, with at most ``MAX_WORKERS`` workers. :func:`check_entitlements` raises
:class:`LicenseError` unless the key grants every entitlement asked for;
:func:`check_worker_count` holds a worker count to the free tier's cap unless the key
grants ``unlimited-workers``.
"""

from __future__ import annotations

MAX_WORKERS = 8  # free-tier cap (reference config.rs:7)

ENTITLEMENT_UNLIMITED_WORKERS = "unlimited-workers"
ENTITLEMENT_XPACK_SHAREPOINT = "xpack-sharepoint"


class LicenseError(RuntimeError):
    pass


def _entitlements() -> set[str]:
    from pathway_tpu_torch.internals.config import get_pathway_config

    key = get_pathway_config().license_key
    if not key:
        return set()
    if not key.startswith("pathway-tpu:"):
        raise LicenseError(
            f"unrecognized license key format {key[:16]!r}..."
        )
    return {e.strip() for e in key.split(":", 1)[1].split(",") if e.strip()}


def check_entitlements(*entitlements: str) -> None:
    """Raise LicenseError unless the active license grants every requested
    entitlement (reference check_entitlements python_api.rs:5538)."""
    have = _entitlements()
    missing = [e for e in entitlements if e not in have]
    if missing:
        raise LicenseError(
            f"the active license does not grant: {', '.join(missing)}; set a "
            f"key with pw.set_license_key('pathway-tpu:<entitlements>')"
        )


def check_worker_count(n_workers: int) -> None:
    """Free tier caps logical workers at MAX_WORKERS (reference
    config.rs:7-11)."""
    if n_workers <= MAX_WORKERS:
        return
    if ENTITLEMENT_UNLIMITED_WORKERS in _entitlements():
        return
    raise LicenseError(
        f"{n_workers} workers exceeds the free tier's {MAX_WORKERS}; license "
        f"with the {ENTITLEMENT_UNLIMITED_WORKERS!r} entitlement to raise it"
    )
