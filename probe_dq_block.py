#!/usr/bin/env python3
"""Time the flash-attention dQ kernel's block shapes at the train shape, on one card.

    python3 probe_dq_block.py

Builds ``pathway_tpu_torch/csrc/flash_attention_bwd.cu`` once per variant, with the dQ
kernel's warps a block (16 query rows each) and its K/V ring depth set in a copy of the
source, into ``pathway_tpu_torch/_build/probe/`` (git-ignored); holds each variant's dq
against the plain version (the 2e-2 bf16 bar of chip_smoke.py, relative to
max(1, |plain|)); and times each at b=1024, t=128, h=12, d=32, bf16, with 10-34 real
keys a sequence, with CUDA events, in the order A B C D D C B A. Prints one JSON line a
variant, each beside the card's name and power limit. The shape kept in the source is
the one chip_smoke.py measures; this script only reads the others.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys

import torch

from pathway_tpu_torch import _build
from pathway_tpu_torch.ops import flash_attention as fa

VARIANTS = [(2, 2), (4, 2), (4, 3), (4, 4), (8, 2)]  # (warps a block, K/V ring stages)
SHAPE = (1024, 128, 12, 32)
ITERS = 50


def variant_source(text: str, warps: int, stages: int) -> str:
    """The source with the dQ block struct's warps and ring depth replaced."""
    struct = re.search(r"struct Dq \{.*?\n\};", text, re.S)
    body = re.sub(r"kWarps = \d+;", f"kWarps = {warps};", struct.group(0))
    body = re.sub(r"kStages = \d+;", f"kStages = {stages};", body)
    return text[: struct.start()] + body + text[struct.end():]


def build(warps: int, stages: int) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe" / f"w{warps}s{stages}"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "flash_common.cuh", out)
    src = out / "flash_attention_bwd.cu"
    src.write_text(variant_source((_build.CSRC / "flash_attention_bwd.cu").read_text(), warps, stages))
    lib = out / "libprobe.so"
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True).stdout
    regs = re.findall(r"flash_bwd_dq_mma_kernelILi32E.*?Used (\d+) registers", log, re.S)
    print(json.dumps({"variant": f"w{warps}s{stages}", "ptxas_dq_mma_d32_registers": regs[:1]}), flush=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dq_block: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    b, t, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = fa.split_heads(qkv, h)
    real = torch.randint(10, 35, (b,), generator=gen, device="cuda")
    bias = fa.mask_bias(torch.arange(t, device="cuda")[None, :] < real[:, None])
    do = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    ref, _ = fa.flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse)

    kern = fa.BWD_DQ_KERNEL
    fns, libs = {}, {}
    for warps, stages in VARIANTS:
        libs[(warps, stages)] = build(warps, stages)
        fn = libs[(warps, stages)].pt_flash_attention_bwd_dq
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        fns[(warps, stages)] = fn
    times = {key: [] for key in fns}
    for key in [*fns, *reversed(list(fns))]:
        # the wrapper's checks and argument order, this variant's library
        kern._fn, kern._lib = fns[key], libs[key]
        dq, _ = fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse)
        err = ((dq.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
        if not err <= 2e-2:
            raise RuntimeError(f"variant {key}: dq error {err}")
        for _ in range(5):
            fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse)
        end.record()
        torch.cuda.synchronize()
        times[key].append(start.elapsed_time(end) / ITERS)
    for (warps, stages), ms in times.items():
        print(json.dumps({"phase": "dq_block", "card": smi, "warps": warps, "rows_per_block": 16 * warps,
                          "stages": stages, "shape": list(SHAPE), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
