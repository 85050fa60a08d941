"""The method namespaces of column expressions: ``.str``, ``.dt`` and ``.num``.

Counterpart of ``pathway_tpu/internals/expressions/``: each method builds an
``ApplyExpression`` over the column (``None`` in, ``None`` out, but where a method
says otherwise), which the engine evaluates per row.
"""
