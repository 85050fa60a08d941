"""The ``pw.this``, ``pw.left`` and ``pw.right`` placeholders.

A copy of ``pathway_tpu/internals/thisclass.py``: placeholders are resolved eagerly by
the consuming method (``select``, ``filter``, ``join``, ``reduce``) via
:mod:`pathway_tpu_torch.internals.desugaring`; ``pw.this.ix_ref(...)`` resolves when
the consuming method binds ``pw.this`` to a table.
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


class DelayedIxRefColumn(ColumnExpression):
    """``pw.this.ix_ref(*keys).column`` — the whole chain resolves when
    the consuming select/reduce binds pw.this to a concrete table: the
    table indexes ITSELF by the key expressions (reference delayed
    ix_ref, thisclass.py ix handling)."""

    def __init__(
        self, owner: "ThisMetaclass", args: tuple, kwargs: dict, name: str
    ) -> None:
        self._owner = owner
        self._ix_args = args
        self._ix_kwargs = kwargs
        self._name = name
        self._dtype = dt.ANY

    @property
    def name(self) -> str:
        return self._name

    def _dependencies(self):
        raise RuntimeError(
            f"pw.{self._owner._side}.ix_ref(...) used outside of a table "
            f"context"
        )

    def __repr__(self) -> str:
        return f"pw.{self._owner._side}.ix_ref(...).{self._name}"


class DelayedIxRef:
    """Result of ``pw.this.ix_ref(...)`` — column access yields the
    delayed expression."""

    def __init__(
        self, owner: "ThisMetaclass", args: tuple, kwargs: dict
    ) -> None:
        self._owner = owner
        self._args = args
        self._kwargs = kwargs

    def __getattr__(self, name: str) -> DelayedIxRefColumn:
        if name.startswith("_"):
            raise AttributeError(name)
        return DelayedIxRefColumn(self._owner, self._args, self._kwargs, name)

    def __getitem__(self, name: str) -> DelayedIxRefColumn:
        return DelayedIxRefColumn(self._owner, self._args, self._kwargs, name)


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

    def ix_ref(self, *args: Any, **kwargs: Any) -> DelayedIxRef:
        return DelayedIxRef(self, args, kwargs)

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
left = ThisMetaclass("left")
right = ThisMetaclass("right")


def is_this_ref(value: Any) -> bool:
    return isinstance(value, ThisColumnReference)
