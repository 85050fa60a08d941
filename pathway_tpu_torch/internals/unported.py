"""Names of the reference that the port has not ported yet: a module-level
``__getattr__`` that raises ``NotImplementedError`` naming the ROADMAP item that ports
each of them, and ``AttributeError`` for any other name (so ``getattr`` with a default,
``hasattr`` and ``from ... import`` of a real submodule behave as usual)."""

from __future__ import annotations

from typing import Callable


def module_getattr(module: str, unported: dict[str, str]) -> Callable[[str], object]:
    """The ``__getattr__`` of ``module``; ``unported`` maps each name to its item, as
    ``"8: the rest of the package"``."""

    def __getattr__(name: str) -> object:
        item = unported.get(name)
        if item is None:
            raise AttributeError(f"module {module!r} has no attribute {name!r}")
        raise NotImplementedError(
            f"{module}.{name} is not ported yet (ROADMAP queue 1 item {item})"
        )

    return __getattr__
