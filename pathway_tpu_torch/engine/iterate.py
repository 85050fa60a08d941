"""Fixed-point iteration's engine node (``pw.iterate``).

Counterpart of ``pathway_tpu/engine/iterate.py``. Pathway nests a timely scope with
product timestamps for the iteration; here a host-driven loop stands in for the nesting:
on every commit that changes one of its inputs, the node reruns the iteration body over
the inputs' current state until the iterated tables stop changing (or the step limit
hits), then emits the difference against its previous output. The body's operators
(joins, groupbys) run on the device as they do anywhere else.
"""

from __future__ import annotations

from typing import Callable, Sequence

from pathway_tpu_torch.engine.batch import DeltaBatch
from pathway_tpu_torch.engine.graph import Node, Scope


class IterateNode(Node):
    """Recompute on change: ``compute(input_states) -> output_state`` runs the whole
    fixed point over the inputs' key -> row states and returns the output table's."""

    def __init__(
        self,
        scope: Scope,
        inputs: Sequence[Node],
        arity: int,
        compute: Callable[[list[dict]], dict],
    ) -> None:
        super().__init__(scope, list(inputs), arity)
        self.compute = compute

    def process(self, time: int) -> DeltaBatch:
        changed = False
        for port in range(len(self.inputs)):
            if self.take(port):
                changed = True
        out = DeltaBatch()
        if not changed:
            return out
        try:
            new_state = self.compute([inp.current for inp in self.inputs])
        except Exception as e:  # noqa: BLE001 — the body's error goes to the error log
            self.report(None, f"iterate error: {e!r}")
            return out
        for key, row in self.current.items():
            if new_state.get(key) != row:
                out.append(key, row, -1)
        for key, row in new_state.items():
            if self.current.get(key) != row:
                out.append(key, row, 1)
        return out
