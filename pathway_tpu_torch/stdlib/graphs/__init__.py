"""Graph algorithms over ``pw.iterate``: PageRank, Bellman-Ford and shortest paths.

Counterpart of ``pathway_tpu/stdlib/graphs/__init__.py``, after Pathway's
``python/pathway/stdlib/graphs/`` (pagerank/, bellman_ford/). Each round of PageRank is
two joins and a float64 ``groupby(...).reduce(sum)``, which the engine's device
operators take. ``louvain_communities`` is not ported yet: the JAX package's version
runs networkx (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import math
from typing import Any

from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import apply as pw_apply
from pathway_tpu_torch.internals.expression import coalesce, if_else
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.table import Table

_INF = math.inf


def _vertices_of(edges: Table) -> Table:
    us = edges.groupby(edges.u).reduce(v=edges.u)
    vs = edges.groupby(edges.v).reduce(v=edges.v)
    return us.update_rows(vs)


def pagerank(
    edges: Table,
    iteration_limit: int = 50,
    damping: float = 0.85,
) -> Table:
    """PageRank over an edge table ``(u, v)`` — returns ``(v, rank)``
    (reference: stdlib/graphs/pagerank)."""
    vertices = _vertices_of(edges)
    out_deg = edges.groupby(edges.u).reduce(v=edges.u, deg=reducers.count())
    ranks0 = vertices.select(v=vertices.v, rank=1.0)

    def body(ranks: Table) -> dict:
        with_rank = edges.join(ranks, edges.u == ranks.v).select(
            u=edges.u, v=edges.v, rank=ranks.rank
        )
        shares = with_rank.join(
            out_deg, with_rank.u == out_deg.v
        ).select(v=with_rank.v, share=with_rank.rank / out_deg.deg)
        inflow = shares.groupby(shares.v).reduce(
            v=shares.v, total=reducers.sum(shares.share)
        )
        new_ranks = vertices.join_left(
            inflow, vertices.v == inflow.v, id=vertices.id
        ).select(
            v=vertices.v,
            rank=pw_apply(
                lambda t: round((1.0 - damping) + damping * (t or 0.0), 12),
                inflow.total,
            ),
        )
        return {"ranks": new_ranks}

    return iterate(body, iteration_limit=iteration_limit, ranks=ranks0).ranks


def bellman_ford(
    vertices: Table,
    edges: Table,
    iteration_limit: int | None = None,
) -> Table:
    """Single-source shortest paths: ``vertices(v, is_source)``,
    ``edges(u, v, dist)`` -> ``(v, dist_from_source)``
    (reference: stdlib/graphs/bellman_ford)."""
    dists0 = vertices.select(
        v=vertices.v,
        dist=if_else(vertices.is_source, 0.0, _INF),
    )

    def body(dists: Table) -> dict:
        relaxed = edges.join(dists, edges.u == dists.v).select(
            v=edges.v, cand=dists.dist + edges.dist
        )
        best = relaxed.groupby(relaxed.v).reduce(
            v=relaxed.v, cand=reducers.min(relaxed.cand)
        )
        new = dists.join_left(best, dists.v == best.v, id=dists.id).select(
            v=dists.v,
            dist=if_else(
                coalesce(best.cand, _INF) < dists.dist,
                coalesce(best.cand, _INF),
                dists.dist,
            ),
        )
        return {"dists": new}

    return iterate(body, iteration_limit=iteration_limit, dists=dists0).dists


def shortest_paths(edges: Table, source: Any, **kw: Any) -> Table:
    """Convenience wrapper: build the vertex table from edges + a source id."""
    vertices = _vertices_of(edges)
    vt = vertices.select(
        v=vertices.v, is_source=pw_apply(lambda x: x == source, vertices.v)
    )
    return bellman_ford(vt, edges, **kw)



def louvain_communities(edges: Table, *, resolution: float = 1.0, seed: int = 0) -> Table:
    raise NotImplementedError(
        "stdlib.graphs.louvain_communities is not ported yet "
        "(ROADMAP queue 1 item 8: the rest of the package; it needs networkx)"
    )
