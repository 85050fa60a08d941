"""The ``pw.this`` placeholder.

Counterpart of ``pathway_tpu/internals/thisclass.py``: placeholders are resolved
eagerly by the consuming method (``select``) via
:mod:`pathway_tpu_torch.internals.desugaring`. ``pw.left``, ``pw.right`` and
``pw.this.ix_ref`` wait for the join and ix operators.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression


class ThisColumnReference(ColumnExpression):
    """``pw.this.colname`` — bound to a concrete table at call time."""

    def __init__(self, owner: "ThisMetaclass", name: str) -> None:
        self._owner = owner
        self._name = name
        self._dtype = dt.ANY

    @property
    def name(self) -> str:
        return self._name

    def _dependencies(self):
        raise RuntimeError(
            f"pw.{self._owner._side}.{self._name} used outside of a table context"
        )

    def __repr__(self) -> str:
        return f"pw.{self._owner._side}.{self._name}"


class ThisStar:
    """``*pw.this`` marker: select expands it to every column of the
    bound table (reference thisclass __iter__ mock, thisclass.py:103)."""

    def __init__(self, owner: "ThisMetaclass") -> None:
        self._owner = owner

    def __repr__(self) -> str:
        return f"*pw.{self._owner._side}"


class ThisMetaclass:
    def __init__(self, side: str) -> None:
        self._side = side

    def __getattr__(self, name: str) -> ThisColumnReference:
        # engine-provided columns (_pw_window_start, _pw_instance, ...) are
        # addressable by attribute, like the reference (_window.py usage);
        # other underscore names stay AttributeError so copy/pickle probes
        # of the sentinel don't manufacture ghost columns
        if name.startswith("_") and not name.startswith("_pw_"):
            raise AttributeError(name)
        return ThisColumnReference(self, name)

    def __getitem__(self, name: str) -> ThisColumnReference:
        if not isinstance(name, str):
            # guards the implicit-iteration protocol: without this,
            # ``*pw.this`` would loop forever on integer indices
            raise TypeError(f"pw.{self._side}[...] needs a column name")
        return ThisColumnReference(self, name)

    def __iter__(self):
        return iter([ThisStar(self)])

    def __repr__(self) -> str:
        return f"pw.{self._side}"


this = ThisMetaclass("this")


def is_this_ref(value: Any) -> bool:
    return isinstance(value, ThisColumnReference)
