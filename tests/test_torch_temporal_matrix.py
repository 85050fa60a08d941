"""The JAX package's temporal matrices, run on the port: the programs and expected
answers of ``tests/test_temporal_matrix.py`` (every window kind under every behavior,
final states and update streams) and ``tests/test_temporal_join_matrix.py`` (the
interval, asof, asof-now and window joins in each ``how``, at the engine node and through
``pw.run``, against brute-force oracles), compiled against ``pathway_tpu_torch``.

Each source is read, its imports of ``pathway_tpu`` are pointed at the port, and its
test classes are collected here under a prefix (``Matrix``, ``JoinMatrix``), so every
program and assertion of the two files holds for both packages: the JAX package in the
original files, the port here. The port's device operators run on the CPU."""

from __future__ import annotations

import os
import re
import types

import pytest

from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G

_HERE = os.path.dirname(os.path.abspath(__file__))

#: the JAX package's module paths that the port lays out otherwise
_IMPORTS = {
    "from pathway_tpu.engine import Scheduler, Scope, ref_scalar": (
        "from pathway_tpu_torch.engine.graph import Scheduler, Scope\n"
        "from pathway_tpu_torch.engine.value import ref_scalar"
    ),
}


def _on_the_port(filename: str) -> types.ModuleType:
    with open(os.path.join(_HERE, filename)) as f:
        source = f.read()
    for old, new in _IMPORTS.items():
        source = source.replace(old, new)
    source = re.sub(r"\bpathway_tpu\b", "pathway_tpu_torch", source)
    assert "pathway_tpu." not in source.replace("pathway_tpu_torch", "")
    module = types.ModuleType(f"torch_{filename[:-3]}")
    module.__file__ = os.path.join(_HERE, filename)
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


for _prefix, _filename in (("Matrix", "test_temporal_matrix.py"),
                           ("JoinMatrix", "test_temporal_join_matrix.py")):
    _module = _on_the_port(_filename)
    for _name, _obj in vars(_module).items():
        if _name.startswith("Test") and isinstance(_obj, type):
            globals()[f"Test{_prefix}{_name[4:]}"] = _obj
        elif _name.startswith("test_") and callable(_obj):
            globals()[f"test_{_prefix.lower()}_{_name[5:]}"] = _obj
del _prefix, _filename, _module, _name, _obj


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    G.clear()
