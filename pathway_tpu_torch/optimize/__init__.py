"""Pre-execution graph rewriter.

Counterpart of ``pathway_tpu/optimize/``. Runs between graph capture and scheduling:
every scheduler calls :func:`optimize_scopes` on its scope before any batch flows. The
passes, in order:

1. **placement** (:mod:`.placement`): annotation only. Marks the operators eligible for
   the device operators (the groupby's segment reduction, the join's pair matcher, the
   external KNN index) and seeds the measurement-driven policy that picks host or card
   per batch at run time. Unlike the rewriting passes it also runs on graphs whose
   operators shadow ``node.index``, since it keys no rewrite off the index; it is a
   no-op when ``PATHWAY_TPU_DEVICE_OPS=0``.
2. **projection pushdown** (:mod:`.pushdown`): narrow StaticSource/Expression producers
   to the columns their consumers read.
3. **exchange elision** (:mod:`.elide`): mark the provably redundant exchange edges. On
   one card the marks reach only the fingerprint and the stats.
4. **stateless-chain fusion** (:mod:`.fuse`): collapse linear Expression/Filter runs
   into one FusedChainNode evaluating the whole chain in one columnar sweep per batch.

Every rewrite mutates the node list in place and never adds or removes a slot:
``node.index == position`` holds after it, so fused interiors stay behind as inert
placeholders.

``PATHWAY_TPU_OPTIMIZE=0`` disables every pass; analyze mode (``PATHWAY_TPU_ANALYZE=1``)
does too, so an analysis would describe the graph the user wrote.
"""

from __future__ import annotations

import os

from pathway_tpu_torch.optimize import elide as _elide
from pathway_tpu_torch.optimize import fuse as _fuse
from pathway_tpu_torch.optimize import placement as _placement
from pathway_tpu_torch.optimize import pushdown as _pushdown
from pathway_tpu_torch.optimize.fuse import FusedChainNode

__all__ = [
    "FusedChainNode",
    "enabled",
    "optimize_scopes",
    "optimizer_stats",
]

_ZERO_STATS = {
    "chains_fused": 0,
    "nodes_fused": 0,
    "columns_dropped": 0,
    "exchanges_elided": 0,
}

#: counters from the most recent optimize_scopes() run in this process
_LAST_STATS = dict(_ZERO_STATS)


def enabled() -> bool:
    """True unless ``PATHWAY_TPU_OPTIMIZE`` turns the rewriter off."""
    return os.environ.get("PATHWAY_TPU_OPTIMIZE", "1").strip().lower() not in (
        "0",
        "false",
        "off",
    )


def optimizer_stats() -> dict:
    """Counters from the most recent :func:`optimize_scopes` run: ``chains_fused``,
    ``nodes_fused``, ``columns_dropped``, ``exchanges_elided``, and with the device
    operators on ``device_eligible`` and ``device_placed``."""
    return dict(_LAST_STATS)


def optimize_scopes(
    scopes: list, n_shared: int | None = None, protected=()
) -> set[tuple[int, int, int]]:
    """Rewrite ``scopes`` in place; idempotent per graph.

    ``scopes[0]`` is the primary (decision) scope and every rewrite is replayed on the
    others by node index. ``n_shared`` bounds the region the scopes share (the primary
    may carry extra trailing sink nodes); ``protected`` adds node indices whose
    consumers the caller cannot see. The port runs one scope on one card; the
    multi-scope form is kept for the sharded runners (ROADMAP queue 1 item 14).

    Returns the runtime exchange-elision set of ``(producer_index, consumer_index,
    port)`` triples.
    """
    global _LAST_STATS
    primary = scopes[0]
    done = getattr(primary, "_pw_opt_elided", None)
    if done is not None:
        return done
    from pathway_tpu_torch.analysis import runtime as _aruntime

    if not enabled() or _aruntime.enabled():
        _LAST_STATS = dict(_ZERO_STATS)  # the last run applied no rewrite
        return set()
    # placement is annotation only, so it may run before the index guard below
    dev_eligible, dev_placed = _placement.run_pass(scopes)
    dev_stats = {"device_eligible": dev_eligible, "device_placed": dev_placed}
    for i, node in enumerate(primary.nodes):
        if not (isinstance(node.index, int) and node.index == i):
            # an operator that shadows ``.index``: every rewrite replay and elision
            # triple keys off ``node.index == position``, so leave the graph untouched
            _LAST_STATS = dict(_ZERO_STATS, **dev_stats)
            primary._pw_opt_fingerprint = []
            primary._pw_opt_elided = set()
            return primary._pw_opt_elided
    if n_shared is None:
        n_shared = min(len(s.nodes) for s in scopes)
    protected = set(protected)
    for node in primary.nodes[:n_shared]:
        if any(c.index >= n_shared for c, _p in node.consumers):
            protected.add(node.index)

    dropped, fingerprint = _pushdown.run(scopes, n_shared, protected)
    marks = _elide.plan(primary, n_shared)
    chains = _fuse.find_chains(primary, n_shared, protected)
    runtime_marks = _elide.remap_through_fusion(marks, chains)
    for scope in scopes:
        for chain in chains:
            _fuse.apply_chain(scope, chain)
    for chain in chains:
        fingerprint.append("fuse:" + ",".join(map(str, chain)))
    if marks:
        fingerprint.append("elide:" + ";".join("%d>%d.%d" % m for m in sorted(marks)))

    stats = {
        "chains_fused": len(chains),
        "nodes_fused": sum(len(c) for c in chains),
        "columns_dropped": dropped,
        "exchanges_elided": len(marks),
        **dev_stats,
    }
    primary._pw_opt_stats = stats
    primary._pw_opt_fingerprint = fingerprint
    primary._pw_opt_elided = runtime_marks
    _LAST_STATS = stats
    return runtime_marks
