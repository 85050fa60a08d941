"""The port's JMESPath-subset evaluator (``pathway_tpu_torch/internals/jmespath_lite``)
against the JAX package's, expression by expression over the same metadata: the same
value, or the same error class and message. It is pure Python on both sides, so every
answer is exact."""

from __future__ import annotations

import pytest

from pathway_tpu.internals import jmespath_lite as jj
from pathway_tpu_torch.internals import jmespath_lite as tj

DOCS = [
    {"path": "docs/a/report.pdf", "owner": "alice", "size": 4, "tags": ["x", "y"],
     "meta": {"lang": "en", "pages": 12, "path": "/srv/in/a.md"}, "draft": False, "none": None},
    {"path": "/b/notes.txt", "owner": "bob", "size": 0.5, "tags": [], "meta": {}, "draft": True},
    {},
]

EXPRESSIONS = [
    "globmatch('**/*.pdf', path)",
    "globmatch('*.pdf', path)",
    "globmatch('/b/*', path)",
    "globmatch('docs/**', path)",
    "globmatch('**', path)",
    "globmatch('/srv/**/a.md', meta.path)",
    "owner == 'alice'",
    "owner != 'alice'",
    "owner == 'bob' || size > 3",
    "contains(path, 'report') && size <= 4",
    "contains(tags, 'x')",
    "contains(owner, 'li')",
    "starts_with(path, 'docs')",
    "ends_with(path, '.txt')",
    "to_string(size) == '4'",
    "missing == null",
    "none == null",
    "!draft",
    "!(size > 1)",
    "size >= `4`",
    "size < 1",
    "meta.lang == 'en'",
    "meta.pages > `10` && owner == 'alice'",
    "meta.missing.deeper == null",
    "`true`",
    "`{\"a\": 1}`",
    "draft == `false`",
    "size == 4.0",
    "size == -1",
    "'it''s'",
    "owner == 'alice' && (size > 10 || contains(tags, 'y'))",
    # malformed or unknown: both sides raise, with the same message
    "owner ==",
    "unknown_fn(path)",
    "(owner == 'alice'",
    "owner == 'alice')",
    "globmatch(path)",
    "size > 'x'",
    "",
]


def _answer(mod, expression, doc):
    try:
        return ("value", mod.search(expression, doc))
    except mod.JMESPathError as e:
        return ("JMESPathError", str(e))
    except Exception as e:  # noqa: BLE001 - the class must match too
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("expression", EXPRESSIONS)
def test_search_matches_jax(expression):
    for doc in DOCS:
        assert _answer(tj, expression, doc) == _answer(jj, expression, doc), (expression, doc)


@pytest.mark.parametrize("pattern, path", [
    ("**/*.pdf", "a/b/c.pdf"),
    ("**/*.pdf", "c.pdf"),
    ("*.pdf", "a/c.pdf"),
    ("a/?/c", "a/b/c"),
    ("a/[bc]/d", "a/c/d"),
    ("**", ""),
    ("/d/1*", "/d/17"),
    ("/d/1*", "/d/2"),
])
def test_globmatch_matches_jax(pattern, path):
    assert tj.globmatch(pattern, path) == jj.globmatch(pattern, path)


def test_the_errors_are_their_own_class():
    assert issubclass(tj.JMESPathError, Exception)
    with pytest.raises(tj.JMESPathError):
        tj.search("owner ==", {"owner": "a"})
