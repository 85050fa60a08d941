#!/usr/bin/env python3
"""Time the int64 segment sum's two paths at the shapes the relational path gives it,
on one card.

    python3 probe_int_sum.py

``pt_segment_sum_int`` (``pathway_tpu_torch/csrc/segment_reduce.cu``) picks one of two
paths by shape in ``int_sums_shared``: per-block sums in shared memory flushed with
global atomics, or warp-aggregated global atomics. This script builds two copies of the
source, one with that choice set to the shared path wherever the sums fit a block and one
set to the global path, into ``pathway_tpu_torch/_build/probe/`` (git-ignored); holds
each against ``np.add.at`` bit for bit; and times each on the profiler's device busy
time (every kernel and memset of the call, averaged over a window of calls), in the
order shared, global, global, shared at every shape. The shapes: groupby_sum's count
([1M, 1,024], index i % 1,024), its diffs with an int sum beside them (two columns),
wordcount's [1M, 4,096], one of incremental_update's 2,000-row commits over 1,000 groups,
and a grid of rows by groups with uniform random indices. Prints one JSON line a shape,
each beside the card's name and power limit. The rule kept in the source is the one
chip_smoke.py runs; this script only reads the two paths.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from pathway_tpu_torch import _build
from pathway_tpu_torch.ops import segment_reduce as sr

VARIANTS = {
    "shared": "return groups * cols * 8 <= c.smem_optin;",
    "global": "return false;",
}
# (rows, groups, int64 columns, index)
SHAPES = [
    (1_000_000, 1024, 1, "modulo"),
    (1_000_000, 1024, 2, "modulo"),
    (1_000_000, 4096, 1, "uniform"),
    (2_000, 1_000, 1, "incremental"),
    *[(n, g, 1, "uniform") for n in (16_384, 131_072, 1_000_000) for g in (8, 1024, 4096, 16_384)],
]
CALLS = 20  # calls in each profiler window


def variant_source(text: str, body: str) -> str:
    """The source with ``int_sums_shared``'s body replaced by ``body``."""
    m = re.search(r"(bool int_sums_shared\([^)]*\) \{\n).*?\n\}", text, re.S)
    return text[: m.start()] + m.group(1) + "  " + body + "\n}" + text[m.end():]


def build() -> dict[str, ctypes.CDLL]:
    text = (_build.CSRC / "segment_reduce.cu").read_text()
    running = {}
    for name, body in VARIANTS.items():
        out = _build.BUILD_DIR / "probe" / f"int_{name}"
        out.mkdir(parents=True, exist_ok=True)
        src = out / "segment_reduce.cu"
        src.write_text(variant_source(text, body))
        lib = out / "libprobe.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        running[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def busy_ms(fn) -> float:
    """The device time of one ``fn()`` call: the profiler's sum over every device-side
    event of ``CALLS`` calls, over ``CALLS``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / CALLS


def index(n: int, groups: int, kind: str, gen) -> np.ndarray:
    if kind == "modulo":
        return np.arange(n, dtype=np.int64) % groups
    if kind == "incremental":  # each group's row retracted, then inserted
        return np.tile(np.arange(groups, dtype=np.int64), n // groups)
    return gen.integers(0, groups, n).astype(np.int64)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_int_sum: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build()
    kern = sr.INT_SUM
    fns = {}
    for name, lib in libs.items():
        fn = lib.pt_segment_sum_int
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        err = lib.pt_cuda_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        fns[name] = fn
    gen = np.random.default_rng(0)
    for n, groups, cols, kind in SHAPES:
        inverse = index(n, groups, kind, gen)
        w = gen.choice(np.array([-1, 1], np.int64), (cols, n))
        host = np.zeros((cols, groups), np.int64)
        for c in range(cols):
            np.add.at(host[c], inverse, w[c])
        inv_d, w_d = torch.from_numpy(inverse).cuda(), torch.from_numpy(w).cuda()
        times: dict[str, list[float]] = {name: [] for name in fns}
        for name in [*fns, *reversed(list(fns))]:
            # the wrapper's checks and argument order, this variant's library
            kern._fn, kern._lib = fns[name], libs[name]
            got = sr.segment_sum_int(inv_d, w_d, groups)
            if not np.array_equal(got.cpu().numpy(), host):
                raise RuntimeError(f"variant {name} at {(n, groups, cols, kind)}: sums differ")
            for _ in range(3):
                sr.segment_sum_int(inv_d, w_d, groups)
            times[name].append(busy_ms(lambda: sr.segment_sum_int(inv_d, w_d, groups)))
        print(json.dumps({"phase": "int_sum_path", "card": smi, "rows": n, "groups": groups, "columns": cols,
                          "index": kind, **{f"{k}_busy_ms": v for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
