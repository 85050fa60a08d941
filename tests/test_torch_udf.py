"""UDFs and their executors on plain Python functions: ``batch_executor(max_batch_size=3)``
hands the function chunks of at most 3 rows in row order, and the results (values and
per-row failures) equal the JAX package's UDF on the same rows."""

import pytest

from pathway_tpu.internals import udfs as judfs
from pathway_tpu_torch.internals import udfs as tudfs


def _run(udfs, rows, max_batch_size=3, fail_on=None):
    chunks = []

    def fn(a, b):
        chunks.append(list(a))
        if fail_on is not None and fail_on in a:
            raise ValueError("bad chunk")
        return [f"{x}-{y}" for x, y in zip(a, b)]

    udf = udfs.UDF(fn, executor=udfs.batch_executor(max_batch_size=max_batch_size))
    out = udf.execute_rows(rows, n_pos=2)
    return chunks, [(ok, v if ok else type(v).__name__) for ok, v in out]


ROWS = [(i, chr(ord("a") + i)) for i in range(8)]


@pytest.mark.parametrize("fail_on", [None, 4])
def test_batch_executor_chunks_in_row_order_as_jax(fail_on):
    ours = _run(tudfs, ROWS, fail_on=fail_on)
    theirs = _run(judfs, ROWS, fail_on=fail_on)
    assert ours == theirs
    chunks, results = ours
    assert chunks == [[0, 1, 2], [3, 4, 5], [6, 7]]
    if fail_on is None:
        assert results == [(True, f"{i}-{c}") for i, c in ROWS]
    else:  # the failing chunk fails each of its rows, the others stand
        assert [ok for ok, _ in results] == [True] * 3 + [False] * 3 + [True] * 2


def test_wrong_result_count_fails_the_chunk():
    def fn(a):
        return a[:1]  # one result whatever the chunk's size

    for udfs in (tudfs, judfs):
        udf = udfs.UDF(fn, executor=udfs.batch_executor(max_batch_size=2))
        out = udf.execute_rows([(1,), (2,), (3,)], n_pos=1)
        assert [ok for ok, _ in out] == [False, False, True]


def test_sync_udf_and_keyword_arguments_match_jax():
    def fn(x, *, scale):
        if x < 0:
            raise ValueError("negative")
        return x * scale

    rows = [(1, 10), (-1, 10), (3, 2)]
    got = []
    for udfs in (tudfs, judfs):
        out = udfs.udf(fn).execute_rows(rows, n_pos=1, kw_names=("scale",))
        got.append([(ok, v if ok else str(v)) for ok, v in out])
    assert got[0] == got[1] == [(True, 10), (False, "negative"), (True, 6)]


def test_max_batch_size_needs_a_batch_executor():
    with pytest.raises(ValueError, match="batch executor"):
        tudfs.UDF(lambda x: x, max_batch_size=4)
    udf = tudfs.UDF(lambda x: x, executor=tudfs.batch_executor(), max_batch_size=4)
    assert udf._executor.max_batch_size == 4


def test_async_udfs_are_not_ported_yet():
    """Async UDFs run on the async executor and give the JAX package's per-row values
    and failures, in row order (``tests/test_torch_udf_async.py`` holds the rest)."""
    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop

    async def fn(x, scale):
        if x < 0:
            raise ValueError("negative")
        return x * scale

    rows = [(5, 2), (-1, 2), (3, 2)]
    got = []
    for udfs in (tudfs, judfs):
        udf = udfs.udf(fn)
        assert udf._executor.kind == "async"
        out = udf.execute_rows(rows, n_pos=1, kw_names=("scale",))
        got.append([(ok, v if ok else str(v)) for ok, v in out])
    stop_event_loop()
    assert got[0] == got[1] == [(True, 10), (False, "negative"), (True, 6)]


def test_cache_name_follows_the_jax_rule():
    from pathway_tpu.internals.udfs.caches import fn_cache_name

    def fn(x):
        return x

    assert tudfs.fn_cache_name(fn) == fn_cache_name(fn)
    assert tudfs.UDF(fn)._cache_name == judfs.UDF(fn)._cache_name
