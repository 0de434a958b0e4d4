#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit (nvidia-smi); TF32 off.
2. build — nvcc builds the five kernel sources from the checkout, one
   nvcc per source, started together; each build's time and ptxas
   register and spill lines (by kernel for B6).  It fails if a bf16
   tensor-core kernel spills: the three flash instances and B6's three
   bf16 kernels.
3. kernels — the flash-attention kernel against its plain PyTorch
   version on the card, at the serve shapes and at GQA, window, ragged
   and non-causal shapes, and at head_dim 256 (B5b: recurrentgemma-9b's
   MQA 16:1 with its window of 2048, and a window shorter than S), in
   fp32 (2e-5; the SIMT kernel) and bf16 (3e-2, and within half a bf16
   ulp of the plain version in fp32; the tensor-core kernel); card times
   at the serve shapes (CUDA graph replay) beside the bound, the plain
   version and one PyTorch library call as a yardstick (at S = 2560, SDPA
   with a boolean band mask), each with its share of the bound and its
   ratio to the library call, and the same calls issued one by one from
   Python.
4. ring-kernels — the ring reduce-scatter (B1), allgather (B2), their
   allreduce composition (B3) and the alltoall (B4) against their plain
   versions, bitwise (``torch.equal``), at p in {1, 2, 3, 4, 8}, m in
   {1, 7, 4099, 2^20}, in all six dtypes (integers over their full range,
   so sums wrap), and on a batched ring (p = 8 in blocks of 4); then, at
   the main paths' shapes (B1 and B2 at the allreduce's p = 4 blocks of
   154,892,544 fp32, B4 at the sort's (8, 8, 10,485,760) int32 buckets),
   bitwise once more and card times beside the bytes bound, the plain
   version and one PyTorch call as a yardstick.
5. allreduce — ``Communicator("data", transport="ring").allreduce`` of a
   gradient-sized fp32 payload (qwen1.5-0.5B's parameter count, from the
   port's ``init_params`` on the meta device) at p = 4 emulated ranks:
   exactly 1 B1 and 1 B2 launch; equal to the exact sum and bitwise equal
   to the same call on ``native``.
6. device-ring-kernels — the per-device ring allgather (B8a) and
   reduce-scatter (B8b) on per-device ranks (``repro_torch.core.shard_map``:
   one thread and one stream per rank, every kernel call one launch per
   rank) against their plain versions and against B2/B1 on the stacked
   input, bitwise, at p in {2, 3, 4, 8}, m in {1, 7, 4099, 2^20}, in fp32,
   bf16, fp16, int32, int64 and uint8 (B8b: all but uint8), with one
   rank slowed by a spin kernel on its stream before the call (and, with
   the spins bounded at 5 ms, that rank makes shard_map raise), and with
   the odd ranks' inputs off 16-byte alignment; then, at the allreduce's
   p = 4 and 154,892,544 fp32 per chunk, bitwise once more, and each
   rank's stream time per call (CUDA events, host rendezvous included;
   the slowest rank's) and the wall clock per call beside the bytes
   bound, the plain version's and one PyTorch call's on the stacked
   payload (B2's and B1's yardsticks) as a yardstick.
7. allreduce-device — the same gradient-sized allreduce as 5, but on 4
   per-device ranks (``shard_map``) on ``ring``: exactly 4 B8b and 4 B8a
   launches and no B1/B2/B4; equal to the exact sum and bitwise equal to
   ``native`` on per-device ranks, and, on random fp32, bitwise equal to
   the emulated ranks' ring path (B3); wall clock per call, GB/s of
   payload per rank, peak device memory.
8. sort — ``examples/torch_sample_sort.py`` on ``ring`` at p = 8 with
   2^24 int32 keys per rank: exactly 1 B2 (splitters) and 2 B4 (buckets,
   counts transpose) launches; the output equals ``torch.sort``.
9. serve — full-width qwen1.5-0.5B in bf16 (random weights from a seeded
   ``torch.Generator``) answers 8 requests through
   ``repro_torch.serve.ServeEngine``; every launch counter is set to 0
   just before and read just after, and must show every kernel of the
   path launched (flash attention: prefills x 24 layers).  One request's
   prefill logits through the kernel match the plain-version path, and a
   small fp32 model on the card matches the same model on the CPU.
10. ssd-kernel — the SSD chunked-scan kernel (B6) against its plain
   version on the card: the JAX package's kernel-test shapes and one
   with Q, N and P all off the tensor cores' 16 x 8 tile (Q = 100) in fp32
   and bf16, the serve shapes (S = 100, 128, 256, 1024 at H = 32, P = 64,
   G = 1, N = 128) in fp32 and bf16, one G > 1 and one B > 1 shape, and
   S = 1024 with mamba2's fast decays (exp(dt A) down to e^-20).  fp32
   within 3e-4 (the reference's own tolerance); bf16 within half a bf16
   ulp of the plain version in fp32 on the same inputs, plus 3e-4.  The
   CUDA launches of one call (profiler), and card times at S = 128..1024
   beside the plain version and the bound.
11. serve-ssm — full-width mamba2-370m in bf16 (random weights from a
   seeded ``torch.Generator``) answers 8 requests (prompts of 100-1024
   tokens, 32 new tokens each) through ``ServeEngine``: exactly prefills
   x 48 SSD-scan launches and no other kernel; the 1024-token prompt's
   prefill logits through the kernel match the plain-version path (rel
   L2 < 2%), and a small fp32 mamba2 on the card matches the same model
   on the CPU within 1e-4.  What that 2% limit measures on a 48-layer
   bf16 model is probed by ``python -m repro_torch.launch.ssd_precision``.
12. lru-kernel — the RG-LRU scan kernel (B7) against its plain version
   (the doubling scan) and the sequential loop on the card, within 1e-5
   in fp32: the JAX package's kernel-test shapes, recurrentgemma-9b's
   serve shapes (B = 1, C = 4096, S = 100, 1024, 2048, 2560), B = 3 with
   a ragged C and S, and S = 2560 with decays within 1e-3 of 1; five
   calls at S = 2560 bitwise equal (the one-pass kernel's look-back
   carry is the same fmafs wherever it stops); the CUDA launches of one
   call and each one's device time (profiler); card times at each serve
   shape beside the plain version and the bound.  ``[build]`` fails if
   either B7 kernel spills.
13. reference-hybrid — a small fp32 recurrentgemma (head_dim 256) on the
   card (B7 and B5b) matches the same model on the CPU (plain versions)
   within 1e-4: prefill past the window and 4 decode steps.
14. serve-hybrid — full-width recurrentgemma-9b in bf16 (random weights
   from a seeded ``torch.Generator``) answers 8 requests (prompts of
   100-2560 tokens, 32 new tokens each, max_len 3072, so prefill crosses
   the window of 2048 and decode wraps its ring) through ``ServeEngine``:
   exactly prefills x 26 RG-LRU-scan and prefills x 12 flash launches and
   no other kernel; decode tok/s, prefill seconds by prompt length, peak
   memory.  The 2560-token prompt's prefill logits through the kernels
   match the plain-version path: with the weights in fp32 within rel L2
   1e-4, and in bf16 within the bf16 plain path's own distance from the
   fp32 logits.

Every launch counter is set to 0 just before each main path (allreduce,
allreduce_device, sort, serve, serve_ssm, serve_hybrid) runs and read
just after.  The
last lines are the card's name and power limit, one JSON object with the
kernel table (``launches`` is the sum over the paths, ``launches_by_path``
each path's own count; the flash kernel has one row per head-dim group),
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import operator
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Communicator, KampingError, op, send_buf, shard_map, spmd)
from repro_torch.core.spmd import bound_axis  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.collectives import ops as ring_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rg_lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models.transformer import layer_slots  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside them,
# device memory.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# (B, Sq, Skv, H, KV, D, causal, window)
SERVE_SHAPES = [(1, s, s, 16, 16, 64, True, None) for s in (128, 256, 512,
                                                           1024)]
CHECK_SHAPES = SERVE_SHAPES + [
    (1, 512, 512, 15, 5, 64, True, None),    # GQA, smollm's heads
    (1, 512, 512, 32, 4, 64, True, None),    # GQA 8:1, tinyllama's heads
    (1, 512, 512, 16, 16, 64, True, 96),     # sliding window
    (1, 200, 200, 16, 16, 64, True, None),   # ragged
    (1, 256, 384, 16, 16, 64, False, None),  # non-causal, Sq != Skv
    (2, 256, 256, 8, 2, 128, True, None),    # the head_dim 128 instance
] + [
    # the head_dim 256 instance (B5b): recurrentgemma-9b's local attention
    # (MQA 16:1, window 2048) at a prompt inside and one past the window,
    # a window shorter than S, and a ragged S with GQA
    (1, 2048, 2048, 16, 1, 256, True, 2048),
    (1, 2560, 2560, 16, 1, 256, True, 2048),
    (1, 600, 600, 16, 1, 256, True, 256),
    (2, 130, 130, 4, 2, 256, True, None),
    # the bf16 kernel's 128-row q tiles and 64-key KV tiles: S one past a
    # q tile, and window 0 (every key masked, so the output is 0)
    (1, 2049, 2049, 16, 1, 256, True, None),
    (1, 128, 128, 16, 16, 64, True, 0),
]
# B5b card times: recurrentgemma-9b's local attention at S = 2048 (every
# pair inside the window, so SDPA's causal call is the same function) and
# at S = 2560 (past the window: SDPA with a boolean band mask, causal and
# inside the window, is the same function, as no row is fully masked)
D256_TIME_SHAPES = [(1, 2048, 2048, 16, 1, 256, True, 2048),
                    (1, 2560, 2560, 16, 1, 256, True, 2048)]
# The bf16 tensor-core instances (flash_fwd_tc<D>, D 64, 128, 256, as
# their mangled names spell them), each gated on no spill in [build]
FLASH_TC_KERNELS = ("flash_fwd_tcILi64E", "flash_fwd_tcILi128E",
                    "flash_fwd_tcILi256E")
TOLS = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# The kernel computes in fp32 and rounds its output to bf16 once, so each
# bf16 output lies within half a bf16 ulp (at most 2^-8 relative) of the
# plain version computed in fp32 on the same inputs, plus fp32 rounding.
BF16_HALF_ULP = 2.0 ** -8
BF16_FP32_ATOL = 1e-5
PROMPT_LENS = (100, 130, 200, 260, 300, 420, 520, 600)  # buckets 128..1024
MAX_NEW = 32
# bf16 prefill logits, kernel path vs plain-version path: both compute in
# fp32 and round to bf16, so an attention (or SSD scan) output differs by
# at most one bf16 ulp (2^-8 relative) where the two fp32 sums straddle a
# rounding boundary; qwen's 24 layers, or mamba2's 48, carry such flips
# into the logits at well under 2%.
LOGIT_REL_TOL = 2e-2
# recurrentgemma-9b's bf16 logits are more sensitive: at 2560 tokens on
# an H100 the kernel and plain paths differ by 3.4%, while each lies
# 5.8% from the same weights evaluated in fp32, where the two paths agree
# to 1.4e-5.  So its kernels are held to the plain versions at full
# width in fp32, within 1e-4 (the differential tests' tolerance), and
# its bf16 kernel path to the plain path within the bf16 plain path's
# own distance from fp32, measured in the same run.
FP32_LOGIT_REL_TOL = 1e-4

# Ring kernels: every check is bitwise (torch.equal) against the plain
# version — pure data movement, and sums folded in the same order with the
# same rounding.
RING_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
               torch.int32, torch.int64)
RING_PS = (1, 2, 3, 4, 8)
RING_MS = (1, 7, 4099, 1 << 20)
ALLREDUCE_RANKS = 4            # the data-parallel width of the allreduce
SORT_RANKS, SORT_KEYS = 8, 1 << 24  # the sort: 2^24 int32 keys per rank
RING_SOURCE = ("src/repro_torch/kernels/collectives/csrc/"
               "ring_collectives.cu")
RING_REPLACES = {
    "ring_reduce_scatter": "src/repro/kernels/collectives/collectives.py:117",
    "ring_allgather": "src/repro/kernels/collectives/collectives.py:69",
    "ring_alltoall": "src/repro/kernels/collectives/collectives.py:176",
}
# Per-device ring (B8) on per-device ranks (shard_map): p, m, dtypes of
# the bitwise checks (B8b takes the summable ones: not uint8)
DEVICE_PS = (2, 3, 4, 8)
DEVICE_MS = (1, 7, 4099, 1 << 20)
DEVICE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                 torch.int64, torch.uint8)
DEVICE_SOURCE = "src/repro_torch/kernels/collectives/csrc/device_ring.cu"
DEVICE_REPLACES = {
    "device_ring_allgather":
        "src/repro/kernels/collectives/collectives.py:238",
    "device_ring_reduce_scatter":
        "src/repro/kernels/collectives/collectives.py:294",
}
DEVICE_ITERS = (5, 3)  # timed calls of the kernel, of the plain version

# SSD scan (B6): (B, S, H, P, G, N, chunk).  The JAX package's kernel-test
# shapes (tests/test_kernels.py), then the serve shapes of mamba2-370m
# (H = 32 heads of P = 64, one group, state N = 128, chunk 128; S = 100 is
# one chunk of 100), a G > 1 and a B > 1 shape.
SSD_TEST_SHAPES = [(2, 64, 4, 16, 1, 32, 16), (1, 128, 2, 32, 2, 16, 32),
                   (1, 64, 8, 8, 1, 8, 64), (2, 96, 4, 16, 4, 16, 32)]
SSD_SERVE_SHAPES = [(1, s, 32, 64, 1, 128, 128) for s in (100, 128, 256,
                                                          1024)]
SSD_MORE_SHAPES = [(1, 512, 32, 64, 4, 128, 128),   # 4 groups of 8 heads
                   (4, 256, 32, 64, 1, 128, 128)]   # batch 4
# mamba2's decays: A = -exp(A_log) spans -1..-16, so exp(dt A) reaches
# e^-20 and la, summed over a chunk, thousands; the summation order of la
# then shows in exp(la_i - la_j), which mild decays never exercise.
SSD_FAST_DECAY_SHAPE = (1, 1024, 32, 64, 1, 128, 128)
# Q = 100, N = 40 and P = 24: none a multiple of the bf16 kernel's 16 x 8
# mma tile, so every tile is zero-filled; G = 3 groups of 2 heads, B = 2
SSD_OFF_TILE_SHAPE = (2, 300, 6, 24, 3, 40, 100)
SSD_TIME_SHAPES = [(1, s, 32, 64, 1, 128, 128) for s in (128, 256, 512,
                                                         1024)]
# fp32: the reference's own tolerance (tests/test_kernels.py:71-72).  bf16:
# the kernel computes in fp32 and rounds once, so each output lies within
# half a bf16 ulp of the plain version in fp32, plus that 3e-4.
SSD_TOL = 3e-4
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu"
# B6's kernels: bf16 on the tensor cores in three launches (each gated
# on no spill in [build]), fp32 in one
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_carry", "ssd_chunk_out",
               "ssd_scan_fp32")
SSD_REPLACES = "src/repro/kernels/ssd/ssd.py:69"
SSM_PROMPT_LENS = (100, 128, 256, 384, 512, 640, 896, 1024)

# RG-LRU scan (B7): (B, S, C).  The JAX package's kernel-test shapes
# (tests/test_kernels.py:77-78), recurrentgemma-9b's serve shapes
# (C = lru_width = 4096), B = 3 with a ragged C and S.  fp32 within 1e-5,
# the reference's own tolerance (tests/test_kernels.py:86-87).
LRU_TEST_SHAPES = [(2, 64, 32), (1, 128, 64), (1, 32, 128), (3, 64, 32)]
LRU_SERVE_SHAPES = [(1, s, 4096) for s in (100, 1024, 2048, 2560)]
LRU_MORE_SHAPES = [(3, 1000, 4100), (3, 37, 5)]
LRU_TOL = 1e-5
LRU_SOURCE = "src/repro_torch/kernels/rg_lru/csrc/lru_scan.cu"
# B7's one-pass kernel: 16-byte copies, and element by element (each
# gated on no spill in [build])
LRU_KERNELS = ("lru_scan_vec", "lru_scan_elem")
LRU_REPLACES = "src/repro/kernels/rg_lru/rg_lru.py:59"
HYBRID_PROMPT_LENS = (100, 256, 512, 1024, 1536, 2048, 2304, 2560)
HYBRID_MAX_LEN = 3072


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters, warmup=3):
    """Per-call time of ``iters`` calls issued from Python, between two CUDA
    events: the larger of the host's issue time and the card's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_ms(fn, iters, replays=5):
    """Per-call card time: ``iters`` calls captured in one CUDA graph and
    replayed ``replays`` times between two CUDA events, so the host's
    issue time is not in the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def attention_bound(shape, dtype):
    """(bound_ms, bound_by) from this shape's unmasked pairs and bytes."""
    B, Sq, Skv, H, KV, D, causal, window = shape
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    flops = 4.0 * B * H * D * int(mask.sum())
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def rand_qkv(shape, dtype, gen):
    B, Sq, Skv, H, KV, D, _, _ = shape
    dev = torch.device("cuda")
    q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_kernels():
    """Returns ``{head dims: max_abs_err}`` over the checks and the timed
    rows at head_dim 64 and at 256."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {(64, 128): 0.0, (256,): 0.0}
    for shape in CHECK_SHAPES:
        causal, window = shape[6], shape[7]
        for dtype, tol in TOLS.items():
            q, k, v = rand_qkv(shape, dtype, gen)
            got = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            want = flash_ops.flash_attention(q, k, v, causal=causal,
                                             window=window, force_ref=True)
            err = float((got.float() - want.float()).abs().max())
            ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
            note = ""
            if dtype == torch.bfloat16:
                # a tighter limit than the 3e-2 floor: against the plain
                # version in fp32, within half a bf16 ulp
                want32 = flash_ops.flash_attention(
                    q.float(), k.float(), v.float(), causal=causal,
                    window=window, force_ref=True)
                excess = float(((got.float() - want32).abs()
                                - BF16_HALF_ULP * want32.abs()).max())
                ok = ok and excess <= BF16_FP32_ATOL
                note = (f" | vs fp32 plain: max(|err| - 2^-8 |x|)="
                        f"{excess:.3e} (limit {BF16_FP32_ATOL})")
            print(f"  check {shape} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                  f"tol={tol}{note} {'ok' if ok else 'MISMATCH'}")
            if not ok or not torch.isfinite(got.float()).all():
                raise AssertionError(f"flash kernel disagrees at {shape} "
                                     f"{dtype}: max_abs_err={err}")
            dims = (256,) if shape[5] == 256 else (64, 128)
            max_err[dims] = max(max_err[dims], err)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for shape in SERVE_SHAPES:
        dtype = torch.bfloat16
        q, k, v = rand_qkv(shape, dtype, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: flash_ops.flash_attention(q, k, v)
        plain = lambda: flash_ops.flash_attention(q, k, v, force_ref=True)
        lib = lambda: sdpa(qt, kt, vt, is_causal=True)
        ms, plain_ms, lib_ms = (card_ms(kern, 50), card_ms(plain, 10),
                                card_ms(lib, 50))
        eager = [eager_ms(kern, 50), eager_ms(plain, 10), eager_ms(lib, 50)]
        bound_ms, bound_by = attention_bound(shape, dtype)
        rows.append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"  time S={shape[1]} bf16 (card, graph replay): kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.2%} "
              f"of the bound, {ms / lib_ms:.2f}x sdpa | issued from Python: "
              f"kernel {eager[0]:.5f}, plain {eager[1]:.5f}, sdpa "
              f"{eager[2]:.5f} ms")

    rows256 = []
    for shape in D256_TIME_SHAPES:
        dtype, window = torch.bfloat16, shape[7]
        q, k, v = rand_qkv(shape, dtype, gen)
        kern = lambda: flash_ops.flash_attention(q, k, v, window=window)
        plain = lambda: flash_ops.flash_attention(q, k, v, window=window,
                                                  force_ref=True)
        ms, plain_ms = card_ms(kern, 20), card_ms(plain, 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if shape[1] <= window:  # causal alone is the same function here
            lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            lib_name = "sdpa causal"
        else:  # causal and inside the window, as a boolean band mask
            pos = torch.arange(shape[1], device=q.device)
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
            lib_name = "sdpa band mask"
        torch.testing.assert_close(  # the yardstick computes this function
            lib().transpose(1, 2).float(), plain().float(), atol=3e-2,
            rtol=3e-2)
        lib_ms = card_ms(lib, 20)
        bound_ms, bound_by = attention_bound(shape, dtype)
        rows256.append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
        print(f"  time D=256 S={shape[1]} H=16 KV=1 window {window} bf16 "
              f"(card, graph replay): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, {lib_name} {lib_ms:.5f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.2%} of the "
              f"bound, {ms / lib_ms:.2f}x {lib_name}")
    return max_err, rows, rows256


def phase_reference():
    """A small fp32 model on the card against the same model on the CPU:
    prefill (padded, with true_len) and 4 decode steps.  The card's prefill
    attention is the flash kernel, the CPU's the JAX package's CPU path
    (chunked attention); TF32 is off, so the logits agree to fp32
    rounding (1e-4, the differential tests' tolerance)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                              dtype="float32", param_dtype="float32",
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=64)
    cpu = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu = _to(cpu, "cuda")
    rng = np.random.RandomState(1)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, 40)))
    tl = torch.tensor([40, 23])
    worst = 0.0
    lc, cc = prefill(cpu, {"tokens": toks}, cfg, max_len=48, true_len=tl)
    before = flash_ops.flash_attention.launches
    lg, cg = prefill(gpu, {"tokens": toks.cuda()}, cfg, max_len=48,
                     true_len=tl.cuda())
    if flash_ops.flash_attention.launches != before + cfg.num_layers:
        raise AssertionError("the card's prefill did not launch the kernel")
    for step in range(5):
        if lg.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"logits {tuple(lg.shape)} not finite")
        err = float((lg.cpu() - lc).abs().max())
        worst = max(worst, err)
        if not torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"card vs CPU logits at step {step}: "
                                 f"max_abs {err}")
        nxt = lc[:, 0].argmax(-1)
        lc, cc = decode_step(cpu, cc, nxt, cfg)
        lg, cg = decode_step(gpu, cg, nxt.cuda(), cfg)
    print(f"  fp32 small model, card (flash kernel) vs CPU (chunked "
          f"attention): prefill + 4 decode steps, max_abs {worst:.3e} "
          "(tol 1e-4)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_serve():
    cfg = get_config("qwen1.5-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  qwen1.5-0.5b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params in bf16, init "
          f"{time.perf_counter() - t0:.2f} s")
    engine = ServeEngine(cfg, params, max_len=1024, num_slots=4)
    rng = np.random.RandomState(0)

    def make(n):
        return Request(prompt=rng.randint(1, cfg.vocab_size, (n,))
                       .astype(np.int32), max_new_tokens=MAX_NEW)

    engine.submit(make(64))  # warmup: first-call set-up outside the run
    engine.run_to_completion()
    torch.cuda.synchronize()
    engine.reset_stats()
    reqs = [make(n) for n in PROMPT_LENS]
    for r in reqs:
        engine.submit(r)

    zero_counts()
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["flash_attention"]

    if engine.truncated or len(done) != len(reqs):
        raise AssertionError(f"served {len(done)}/{len(reqs)} requests")
    for r in reqs:
        if len(r.generated) != MAX_NEW:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} "
                                 f"tokens, budget {MAX_NEW}")
    prefills = engine.counters["prefills"]
    if launches != prefills * cfg.num_layers or launches == 0:
        raise AssertionError(f"flash launches {launches} != prefills "
                             f"{prefills} x {cfg.num_layers} layers")
    if any(counts[name] for name in counts if name != "flash_attention"):
        raise AssertionError(f"serve launched another kernel: {counts}")
    decode_tokens = engine.counters["decode_tokens"]
    ph = engine.phase_seconds
    print(f"  served {len(done)}/{len(reqs)} requests (prompts "
          f"{list(PROMPT_LENS)}, {MAX_NEW} new tokens each) in {wall:.4f} s "
          f"over {engine.counters['steps']} steps")
    print(f"  flash-attention launches {launches} = {prefills} prefills x "
          f"{cfg.num_layers} layers")
    print(f"  decode: {decode_tokens} tokens, {decode_tokens / wall:.2f} tok/s "
          f"over the run's wall clock; phase seconds " + ", ".join(
              f"{k}={v:.4f}" for k, v in ph.items()))

    prefill_s = {}
    for n in (100, 200, 400, 600):
        bucket = engine._bucket(n)
        toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (1, bucket)),
                               device="cuda")
        tl = torch.tensor([n], device="cuda")
        run = lambda: prefill(params, {"tokens": toks}, cfg, max_len=1024,
                              true_len=tl)
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        prefill_s[bucket] = (time.perf_counter() - t) / 3
    print("  prefill seconds by bucket: " + ", ".join(
        f"{b}: {s:.5f}" for b, s in prefill_s.items()))

    # kernel path vs plain-version path: last-token prefill logits
    before = flash_ops.flash_attention.launches
    n = PROMPT_LENS[-1]
    toks = torch.zeros((1, engine._bucket(n)), dtype=torch.int64,
                       device="cuda")
    toks[0, :n] = torch.as_tensor(reqs[-1].prompt, device="cuda")
    tl = torch.tensor([n], device="cuda")
    got, _ = prefill(params, {"tokens": toks}, cfg, max_len=1024, true_len=tl)
    want, _ = prefill(params, {"tokens": toks}, cfg, max_len=1024,
                      true_len=tl, force_ref=True)
    got, want = got.float(), want.float()
    if flash_ops.flash_attention.launches != before + cfg.num_layers:
        raise AssertionError("the kernel path did not launch the kernel")
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    rel = float((got - want).norm() / want.norm())
    print(f"  prefill logits, kernel vs plain path (prompt {n}): rel L2 "
          f"{rel:.3e} (tol {LOGIT_REL_TOL}), max_abs "
          f"{float((got - want).abs().max()):.3e}, max |logit| "
          f"{float(want.abs().max()):.3f}")
    if not rel <= LOGIT_REL_TOL:
        raise AssertionError(f"prefill logits disagree: rel L2 {rel}")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# ring collectives
# ---------------------------------------------------------------------------
def _counters():
    return {"flash_attention": flash_ops.flash_attention,
            **{name: getattr(ring_ops, name) for name in RING_REPLACES},
            **{name: getattr(ring_ops, name) for name in DEVICE_REPLACES},
            "ssd_scan": ssd_ops.ssd_scan, "lru_scan": lru_ops.lru_scan}


def read_counts():
    """Every kernel wrapper's launch count."""
    return {name: fn.launches for name, fn in _counters().items()}


def zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def expect_launches(path, launches, **want):
    """Exactly ``want`` launches of the named kernels, none of the others."""
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected:
        raise AssertionError(f"{path} launches {launches}: expected "
                             f"{want} and no other kernel")


def ring_input(shape, dtype, gen):
    """Random payload: gaussian floats, integers over their full range (so
    sums overflow and must wrap)."""
    dev = torch.device("cuda")
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen,
                         device=dev, dtype=dtype)


def bitwise(got, want):
    """(equal, max_abs_err) of a kernel result against its plain version.
    The error is taken 2^26 elements at a time, so a result of billions of
    elements needs no float64 copy of itself."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        return False, float("inf")
    same = got.dtype == want.dtype and torch.equal(got, want)
    g, w = got.reshape(-1), want.reshape(-1)
    err, step = 0.0, 1 << 26
    for lo in range(0, g.numel(), step):
        err = max(err, float((g[lo:lo + step].double()
                              - w[lo:lo + step].double()).abs().max()))
    return same, err


def ring_bound(name, p, m, dtype):
    """(bound_ms, bytes): each input element read once, each output element
    written once, over the card's memory rate.  The adds of B1 (p*p*m) at
    the fp32 peak take under 1% of that, so bytes bound all three."""
    esize = torch.empty((), dtype=dtype).element_size()
    elems = {"ring_reduce_scatter": p * p * m + p * m,
             "ring_allgather": p * m + p * p * m,
             "ring_alltoall": 2 * p * p * m}[name]
    nbytes = elems * esize
    return nbytes / PEAK_BYTES * 1e3, nbytes


def phase_ring_kernels():
    gen = torch.Generator(device="cuda").manual_seed(2)
    err = {name: 0.0 for name in RING_REPLACES}
    err["ring_allreduce"] = 0.0
    n_checks = 0
    cases = [(p, m, 1) for p in RING_PS for m in RING_MS] + [
        (4, m, 2) for m in RING_MS]  # p = 8 ranks as 2 rings of 4
    for dtype in RING_DTYPES:
        for p, m, rings in cases:
            xs = ring_input((rings * p, p, m), dtype, gen)
            row = xs[:, 0].contiguous()
            for name, fn, x in (
                ("ring_reduce_scatter", ring_ops.ring_reduce_scatter, xs),
                ("ring_alltoall", ring_ops.ring_alltoall, xs),
                ("ring_allgather", ring_ops.ring_allgather, row),
                ("ring_allreduce", ring_ops.ring_allreduce, row),
            ):
                same, e = bitwise(fn(x, rings=rings),
                                  fn(x, rings=rings, force_ref=True))
                n_checks += 1
                if not same:
                    raise AssertionError(
                        f"{name} disagrees with its plain version: "
                        f"{str(dtype)[6:]} p={p} m={m} rings={rings} "
                        f"max_abs_err={e}")
                err[name] = max(err[name], e)
            del xs, row
    print(f"  {n_checks} checks bitwise equal: p in {list(RING_PS)}, m in "
          f"{list(RING_MS)}, {len(RING_DTYPES)} dtypes, plus p=8 as 2 rings "
          f"of 4 (max_abs_err {err})")

    # card times at the main paths' shapes
    rows = {}
    p = ALLREDUCE_RANKS
    m = allreduce_elements() // p
    xs = ring_input((p, p, m), torch.float32, gen)
    rows["ring_reduce_scatter"] = time_ring(
        "ring_reduce_scatter", xs, p, m, lambda: xs.sum(0))
    del xs
    torch.cuda.empty_cache()
    x = ring_input((p, m), torch.float32, gen)
    rows["ring_allgather"] = time_ring(
        "ring_allgather", x, p, m,
        lambda: x.unsqueeze(0).expand((p,) + tuple(x.shape)).contiguous())
    del x
    torch.cuda.empty_cache()
    p, m = SORT_RANKS, 2 * int(SORT_KEYS * 2.5 / SORT_RANKS)
    xs = ring_input((p, p, m), torch.int32, gen)
    rows["ring_alltoall"] = time_ring(
        "ring_alltoall", xs, p, m, lambda: xs.transpose(0, 1).contiguous())
    del xs
    torch.cuda.empty_cache()
    for name, row in rows.items():
        row["max_abs_err"] = max(err[name], row["max_abs_err"])
    return rows


def time_ring(name, x, p, m, library):
    """Hold the kernel against its plain version at the main path's shape,
    bitwise, then time both and the library call."""
    fn = getattr(ring_ops, name)
    kern = lambda: fn(x)
    plain = lambda: fn(x, force_ref=True)
    same, err = bitwise(kern(), plain())
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"p={p} m={m}: max_abs_err={err}")
    print(f"  {name} p={p} m={m} {str(x.dtype)[6:]}: bitwise equal to its "
          f"plain version (max_abs_err {err})")
    ms = card_ms(kern, 3, replays=3)
    plain_ms = card_ms(plain, 3, replays=3)
    lib_ms = card_ms(library, 3, replays=3)
    torch.cuda.empty_cache()
    bound_ms, nbytes = ring_bound(name, p, m, x.dtype)
    print(f"  time {name} p={p} m={m} {str(x.dtype)[6:]} (card, graph "
          f"replay): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, library "
          f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms (bytes, "
          f"{nbytes / 1e9:.3f} GB) -> {nbytes / ms / 1e6:.1f} GB/s, "
          f"{bound_ms / ms:.1%} of the bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by="bytes")


def allreduce_elements():
    """qwen1.5-0.5B's parameter count, from the port's init_params on the
    meta device (untied embeddings: lm_head counts)."""
    cfg = get_config("qwen1.5-0.5b")
    if cfg.tie_embeddings:
        raise AssertionError("qwen1.5-0.5b is expected untied")
    return sum(t.numel() for t in _leaves(init_params(cfg, device="meta")))


def phase_allreduce():
    """The data-parallel gradient allreduce on the ring transport."""
    p, n = ALLREDUCE_RANKS, allreduce_elements()
    gen = torch.Generator(device="cuda").manual_seed(3)
    # small integers in fp32: every sum is exact, whatever its order
    g = torch.randint(-8, 8, (p, n), generator=gen, device="cuda",
                      dtype=torch.float32)

    def reduce(transport):
        return spmd(lambda v: Communicator("data", transport=transport)
                    .allreduce(send_buf(v), op(operator.add)), g,
                    axis_name="data")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    out = reduce("ring")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("allreduce", launches, ring_reduce_scatter=1,
                    ring_allgather=1)
    if out.shape != g.shape or out.dtype != g.dtype:
        raise AssertionError(f"allreduce result {tuple(out.shape)}")
    step = 1 << 26
    for lo in range(0, n, step):  # exact sum, column block by block
        want = g[:, lo:lo + step].double().sum(0).float()
        if not torch.equal(out[:, lo:lo + step],
                           want.expand(p, -1)):
            raise AssertionError(f"allreduce differs from the exact sum in "
                                 f"columns {lo}..{lo + step}")
    walls = []
    for _ in range(3):
        del out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce("ring")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    native = reduce("native")
    torch.cuda.synchronize()
    if not torch.equal(out, native):
        raise AssertionError("ring and native allreduce differ")
    del out, native, g
    torch.cuda.empty_cache()
    gb = n * 4 / 1e9
    print(f"  allreduce of {n} fp32 elements ({gb:.3f} GB per rank) over "
          f"{p} ranks on ring: launches {launches}; first call "
          f"{wall * 1e3:.3f} ms, then {', '.join(f'{w * 1e3:.3f}' for w in walls)}"
          f" ms ({gb / min(walls):.1f} GB/s of payload per rank at the "
          f"best); peak device memory {peak / 1e9:.3f} GB "
          f"({(peak - base) / 1e9:.3f} GB above the input); equal to the "
          "exact sum and bitwise equal to native")
    return launches


# ---------------------------------------------------------------------------
# per-device ring (B8) on per-device ranks
# ---------------------------------------------------------------------------
def shifted(t, k):
    """A contiguous copy of ``t`` that starts ``k`` elements into a fresh
    buffer (k = 1: not 16-byte aligned)."""
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:]
    return out.view(t.shape).copy_(t)


def b8_run(xs, slow=None, summable=True, offset=0):
    """B8a on slot 0 and B8b on the whole (p, m) of every rank, kernel and
    plain version, in one shard_map; rank ``slow`` first runs a spin
    kernel (~50 ms) on its stream; the odd ranks' inputs start ``offset``
    elements into their buffers."""
    def fn(v):
        ring = bound_axis("x").ranks
        if ring.rank == slow:
            torch.cuda._sleep(100_000_000)
        if offset:
            v = shifted(v, offset * (ring.rank % 2))
        x0 = shifted(v[0], offset * (ring.rank % 2)) if offset else \
            v[0].contiguous()
        outs = [ring_ops.device_ring_allgather(x0, ring),
                ring_ops.device_ring_allgather(x0, ring, force_ref=True)]
        if summable:
            outs += [ring_ops.device_ring_reduce_scatter(v, ring),
                     ring_ops.device_ring_reduce_scatter(v, ring,
                                                         force_ref=True)]
        return tuple(outs)

    return shard_map(fn, xs, axis_name="x")


def phase_device_ring_kernels():
    gen = torch.Generator(device="cuda").manual_seed(5)
    err = {name: 0.0 for name in DEVICE_REPLACES}
    n_checks = 0

    def check(xs, slow=None, offset=0):
        nonlocal n_checks
        summable = xs.dtype != torch.uint8
        before = read_counts()
        outs = b8_run(xs, slow=slow, summable=summable, offset=offset)
        p = xs.shape[0]
        launched = {name: read_counts()[name] - before[name]
                    for name in DEVICE_REPLACES}
        if launched != {"device_ring_allgather": p,
                        "device_ring_reduce_scatter": p if summable else 0}:
            raise AssertionError(f"B8 launches {launched} at p={p}: "
                                 "expected one per rank per call")
        # B2 has no uint8 kernel: there its plain version is the yardstick
        checks = [("device_ring_allgather", outs[0], outs[1]),
                  ("device_ring_allgather", outs[0], ring_ops.ring_allgather(
                      xs[:, 0].contiguous(), force_ref=not summable))]
        if summable:
            checks += [("device_ring_reduce_scatter", outs[2], outs[3]),
                       ("device_ring_reduce_scatter", outs[2],
                        ring_ops.ring_reduce_scatter(xs))]
        for name, got, want in checks:
            same, e = bitwise(got, want)
            n_checks += 1
            if not same:
                raise AssertionError(
                    f"{name} disagrees: {str(xs.dtype)[6:]} p={p} "
                    f"m={xs.shape[2]} slow={slow} offset={offset} "
                    f"max_abs_err={e}")
            err[name] = max(err[name], e)

    for dtype in DEVICE_DTYPES:
        for p in DEVICE_PS:
            for m in DEVICE_MS:
                check(ring_input((p, p, m), dtype, gen))
    print(f"  {n_checks} checks bitwise equal (kernel = plain version = "
          f"B2/B1 on the stacked input): p in {list(DEVICE_PS)}, m in "
          f"{list(DEVICE_MS)}, {len(DEVICE_DTYPES)} dtypes; one launch per "
          f"rank per call")
    for p, slow in ((4, 2), (8, 5)):
        check(ring_input((p, p, 1 << 20), torch.float32, gen), slow=slow)
        print(f"  p={p} m={1 << 20} fp32 with rank {slow} slowed by a ~50 ms "
              "spin kernel on its stream: bitwise equal")
    # neighbours whose buffers differ in 16-byte alignment must still cut
    # the same tiles (the kernels' load width is agreed across the ranks)
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        check(ring_input((4, 4, 1 << 16), dtype, gen), offset=1)
    print(f"  p=4 m={1 << 16} fp32, bf16, uint8 with the odd ranks' inputs "
          "one element off 16-byte alignment: bitwise equal")
    # with the spins bounded at 5 ms, the same slowed rank must make every
    # spin run out and shard_map raise, not hang or return a result
    saved = ring_ops.SPIN_TIMEOUT_S
    ring_ops.SPIN_TIMEOUT_S = 0.005
    try:
        b8_run(ring_input((4, 4, 1 << 20), torch.float32, gen), slow=1)
    except KampingError as e:
        if "spin ran out" not in str(e):
            raise
        print(f"  spins bounded at 5 ms, rank 1 slowed: shard_map raised "
              f"({str(e)[:110]}...)")
    else:
        raise AssertionError("a device ring spin that ran out did not raise")
    finally:
        ring_ops.SPIN_TIMEOUT_S = saved
    torch.cuda.empty_cache()
    return time_device_ring(gen, err)


def time_device_ring(gen, err):
    """B8a/B8b at the allreduce's p = 4 and chunk: bitwise against their
    plain versions, then each rank's stream time per call (CUDA events
    around calls back to back on its stream, so it includes the host
    rendezvous of every call; the slowest rank is reported) and the wall
    clock per call, for the kernel and the plain version; and the one
    PyTorch call that computes the same function on the stacked payload
    (B2's and B1's library calls)."""
    p = ALLREDUCE_RANKS
    m = allreduce_elements() // p
    xs = ring_input((p, p, m), torch.float32, gen)
    iters = DEVICE_ITERS
    names = list(DEVICE_REPLACES)

    def timed(ring, call, n):
        stream = torch.cuda.current_stream()
        ring.barrier()
        stream.synchronize()
        ring.exchange(None)  # every rank idle
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record(stream)
        for _ in range(n):
            call()
        end.record(stream)
        stream.synchronize()
        wall = time.perf_counter() - t0
        return start.elapsed_time(end) / n, wall * 1e3 / n

    def fn(v):
        ring = bound_axis("data").ranks
        x0 = v[0].contiguous()
        calls = {
            "device_ring_allgather": lambda force: ring_ops.
            device_ring_allgather(x0, ring, force_ref=force),
            "device_ring_reduce_scatter": lambda force: ring_ops.
            device_ring_reduce_scatter(v, ring, force_ref=force),
        }
        vals = []
        for name in names:
            call = calls[name]
            same = torch.equal(call(False), call(True))
            ms, wall = timed(ring, lambda: call(False), iters[0])
            plain_ms, plain_wall = timed(ring, lambda: call(True), iters[1])
            vals += [float(same), ms, wall, plain_ms, plain_wall]
        return torch.tensor(vals, dtype=torch.float64)

    before = read_counts()
    res = shard_map(fn, xs, axis_name="data").cpu()
    torch.cuda.empty_cache()
    row_in = xs[:, 0].contiguous()
    library = {
        "device_ring_allgather": lambda: row_in.unsqueeze(0).expand(
            (p,) + tuple(row_in.shape)).contiguous(),
        "device_ring_reduce_scatter": lambda: xs.sum(0),
    }
    lib_ms = {name: card_ms(library[name], 3, replays=3) for name in names}
    del xs, row_in, library
    torch.cuda.empty_cache()
    rows = {}
    for k, name in enumerate(names):
        launched = read_counts()[name] - before[name]
        if launched != p * (1 + iters[0]):
            raise AssertionError(f"{name}: {launched} launches for "
                                 f"{1 + iters[0]} calls over {p} ranks")
        same, ms, wall, plain_ms, plain_wall = (
            res[:, 5 * k + j] for j in range(5))
        if not bool(same.all()):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at p={p} m={m}: ranks {same.tolist()}")
        stacked = ("ring_allgather" if name == "device_ring_allgather"
                   else "ring_reduce_scatter")
        bound_ms, nbytes = ring_bound(stacked, p, m, torch.float32)
        row = dict(max_abs_err=err[name], ms=float(ms.max()),
                   plain_ms=float(plain_ms.max()), bound_ms=bound_ms,
                   bound_by="bytes", library_ms=lib_ms[name],
                   ms_of="rank stream incl. host rendezvous",
                   wall_ms=float(wall.max()),
                   plain_wall_ms=float(plain_wall.max()))
        print(f"  {name} p={p} m={m} fp32: bitwise equal to its plain "
              f"version on every rank")
        print(f"  time {name} p={p} m={m} fp32 (stream time incl. the "
              f"host rendezvous: CUDA events on each rank's stream, "
              f"{iters[0]} calls back to back): slowest rank "
              f"{row['ms']:.5f} ms per call (ranks "
              f"{', '.join(f'{t:.5f}' for t in ms.tolist())}), wall clock "
              f"{row['wall_ms']:.5f} ms per call; plain version "
              f"{row['plain_ms']:.5f} ms (wall {row['plain_wall_ms']:.5f} "
              f"ms); library {row['library_ms']:.5f} ms (one call on the "
              f"stacked payload); bound {bound_ms:.5f} ms (bytes, "
              f"{nbytes / 1e9:.3f} GB "
              f"as {stacked} on the stacked payload) -> "
              f"{bound_ms / row['ms']:.1%} of the bound; 1 launch per rank "
              f"per call")
        rows[name] = row
    return rows


def phase_allreduce_device():
    """The gradient allreduce of phase 5 on per-device ranks on ring."""
    p, n = ALLREDUCE_RANKS, allreduce_elements()
    gen = torch.Generator(device="cuda").manual_seed(6)
    # small integers in fp32: every sum is exact, whatever its order
    g = torch.randint(-8, 8, (p, n), generator=gen, device="cuda",
                      dtype=torch.float32)

    def reduce(transport, data, run=shard_map):
        return run(lambda v: Communicator("data", transport=transport)
                   .allreduce(send_buf(v), op(operator.add)), data,
                   axis_name="data")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    out = reduce("ring", g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("allreduce_device", launches, device_ring_allgather=p,
                    device_ring_reduce_scatter=p)
    if out.shape != g.shape or out.dtype != g.dtype:
        raise AssertionError(f"allreduce_device result {tuple(out.shape)}")
    step = 1 << 26
    for lo in range(0, n, step):  # exact sum, column block by block
        want = g[:, lo:lo + step].double().sum(0).float()
        if not torch.equal(out[:, lo:lo + step], want.expand(p, -1)):
            raise AssertionError(f"allreduce_device differs from the exact "
                                 f"sum in columns {lo}..{lo + step}")
    walls = []
    for _ in range(3):
        del out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce("ring", g)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    native = reduce("native", g)
    torch.cuda.synchronize()
    if not torch.equal(out, native):
        raise AssertionError("per-device ring and native allreduce differ")
    del out, native, g
    torch.cuda.empty_cache()
    g = torch.randn((p, n), generator=gen, device="cuda")
    dev = reduce("ring", g)
    emulated = reduce("ring", g, run=spmd)
    torch.cuda.synchronize()
    if not torch.equal(dev, emulated):
        raise AssertionError("per-device ring allreduce differs from the "
                             "emulated ranks' ring allreduce (B3) on random "
                             "fp32")
    del dev, emulated, g
    torch.cuda.empty_cache()
    gb = n * 4 / 1e9
    print(f"  allreduce of {n} fp32 elements ({gb:.3f} GB per rank) over "
          f"{p} per-device ranks (shard_map) on ring: launches {launches}; "
          f"first call {wall * 1e3:.3f} ms, then "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms (wall clock per "
          f"call, from the (p, n) input to the stacked result; "
          f"{gb / min(walls):.1f} GB/s of payload per rank at the best); "
          f"peak device memory {peak / 1e9:.3f} GB "
          f"({(peak - base) / 1e9:.3f} GB above the input); equal to the "
          "exact sum and bitwise equal to native on per-device ranks, and on "
          "random fp32 bitwise equal to the emulated ranks' ring path (B3)")
    return launches


def phase_sort():
    """The paper's sample sort (examples/torch_sample_sort.py) on ring."""
    path = os.path.join(HERE, "examples", "torch_sample_sort.py")
    spec = importlib.util.spec_from_file_location("torch_sample_sort", path)
    sort = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sort)
    p, n = SORT_RANKS, SORT_KEYS
    gen = torch.Generator(device="cuda").manual_seed(4)
    data = torch.randint(0, 1 << 30, (p, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    merged, valid = sort.sample_sort(data, gen, transport="ring")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("sort", launches, ring_allgather=1, ring_alltoall=2)
    out = sort.gather_sorted(merged, valid)
    if not torch.equal(out, torch.sort(data.reshape(-1)).values):
        raise AssertionError("sample sort differs from torch.sort")
    cap = sort.capacity(n, p)
    print(f"  sorted {p * n} int32 keys over {p} ranks on ring in "
          f"{wall * 1e3:.3f} ms ({p * n / wall / 1e6:.1f} M keys/s); "
          f"buckets ({p}, {p}, {cap}); launches {launches}; bucket skew "
          f"{float(valid.max()) / n:.4f}x; peak device memory "
          f"{peak / 1e9:.3f} GB; equal to torch.sort")
    del data, merged, valid, out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# SSD scan (B6) and mamba2 serving
# ---------------------------------------------------------------------------
def ssd_inputs(shape, dtype, gen, fast_decay=False):
    """x and Bm/C gaussian (scaled as the JAX package's kernel tests), the
    decay a uniform in [0.3, 0.99] in fp32; with ``fast_decay`` every other
    head decays as exp(-(4 + 16 u)) instead."""
    B, S, H, P, G, N, _ = shape
    dev = torch.device("cuda")
    x = (torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5).to(dtype)
    a = torch.rand(B, S, H, generator=gen, device=dev).clamp(0.3, 0.99)
    if fast_decay:
        u = torch.rand(B, S, (H + 1) // 2, generator=gen, device=dev)
        a[:, :, ::2] = torch.exp(-(4 + 16 * u))
    Bm = (torch.randn(B, S, G, N, generator=gen, device=dev) * 0.3).to(dtype)
    C = (torch.randn(B, S, G, N, generator=gen, device=dev) * 0.3).to(dtype)
    return x, a, Bm, C


def ssd_bound(shape, dtype):
    """(bound_ms, bound_by, bytes, flops).  Bytes: x, a, Bm, C read once,
    y written once.  FLOPs: the least work of the function, the causal
    half of the two Q x Q products (C B^T over N and W x over P, j <= i)
    plus C S and the state update (2 Q N P each), per (b, h, chunk); the
    TPU kernel computes the full Q x Q products."""
    B, S, H, P, G, N, chunk = shape
    Q = min(chunk, S)
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * B * S * H
    pairs = Q * (Q + 1) // 2
    flops = B * H * (S // Q) * (2 * pairs * N + 2 * pairs * P + 4 * Q * N * P)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes",
            nbytes, flops)


def phase_ssd_kernel():
    gen = torch.Generator(device="cuda").manual_seed(5)
    max_err = 0.0
    both = (torch.float32, torch.bfloat16)
    checks = [(s, dt, False) for s in SSD_TEST_SHAPES + [SSD_OFF_TILE_SHAPE]
              + SSD_SERVE_SHAPES + SSD_MORE_SHAPES for dt in both] + [
        (SSD_FAST_DECAY_SHAPE, dt, True) for dt in both]
    for shape, dtype, fast in checks:
        x, a, Bm, C = ssd_inputs(shape, dtype, gen, fast_decay=fast)
        chunk = shape[-1]
        got = ssd_ops.ssd_scan(x, a, Bm, C, chunk=chunk)
        torch.cuda.synchronize()
        want = ssd_ops.ssd_scan(x.float(), a, Bm.float(), C.float(),
                                chunk=chunk, force_ref=True)
        err = float((got.float() - want).abs().max())
        if dtype == torch.float32:
            ok = torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL)
            note = f"tol {SSD_TOL}"
        else:
            excess = float(((got.float() - want).abs()
                            - BF16_HALF_ULP * want.abs()).max())
            ok = excess <= SSD_TOL
            note = (f"vs fp32 plain: max(|err| - 2^-8 |x|)={excess:.3e} "
                    f"(limit {SSD_TOL})")
        ok = ok and bool(torch.isfinite(got.float()).all())
        print(f"  check {shape}{' fast decay' if fast else ''} "
              f"{str(dtype)[6:]}: max_abs_err={err:.3e} {note} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"ssd_scan kernel disagrees at {shape} "
                                 f"{dtype}: max_abs_err={err}")
        max_err = max(max_err, err)

    for shape in (SSD_SERVE_SHAPES[0], SSD_SERVE_SHAPES[-1]):
        for dtype in both:
            x, a, Bm, C = ssd_inputs(shape, dtype, gen)
            n, times = cuda_launches(lambda: ssd_ops.ssd_scan(
                x, a, Bm, C, chunk=shape[-1]))
            print(f"  CUDA launches per call at S={shape[1]} "
                  f"{str(dtype)[6:]}: {n:g} (profiler, by name: launches "
                  "x device us per call: " + ", ".join(
                      f"{k} {c:g} x {us:.2f}"
                      for k, (c, us) in times.items()) + ")")

    rows = []
    for shape in SSD_TIME_SHAPES:
        dtype = torch.bfloat16
        x, a, Bm, C = ssd_inputs(shape, dtype, gen)
        kern = lambda: ssd_ops.ssd_scan(x, a, Bm, C, chunk=shape[-1])
        plain = lambda: ssd_ops.ssd_scan(x, a, Bm, C, chunk=shape[-1],
                                         force_ref=True)
        ms, plain_ms = card_ms(kern, 20), card_ms(plain, 5)
        bound_ms, bound_by, nbytes, flops = ssd_bound(shape, dtype)
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"  time S={shape[1]} bf16 (card, graph replay): kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} "
              f"ms ({bound_by}: {nbytes} bytes, {flops} flops) -> "
              f"{flops / ms / 1e9:.1f} GFLOP/s, {bound_ms / ms:.2%} of the "
              "bound")
    return max_err, rows


def cuda_launches(fn, calls=10):
    """``(launches, {kernel: (launches, us)})``: the CUDA kernels (and
    memsets) one call of ``fn`` runs, in all and by name, with each one's
    device time, per call, from the profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    times = {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        if us and e.count:  # "(anonymous namespace)::ssd_chunk_out(...)"
            name = e.key.replace("(anonymous namespace)::", "")
            times[name.split("(")[0].split("::")[-1].strip()] = (
                e.count / calls, us / calls)
    return n / calls, times


def phase_reference_ssm():
    """A small fp32 mamba2 on the card against the same model on the CPU:
    prefill and 4 decode steps.  The card's scan is the kernel, the CPU's
    its plain version; TF32 is off, so the logits agree to fp32 rounding
    (1e-4, the differential tests' tolerance)."""
    cfg = dataclasses.replace(get_config("mamba2-370m", smoke=True),
                              dtype="float32", param_dtype="float32",
                              d_model=128, ssm_head_dim=32, ssm_state=32,
                              ssm_chunk=16)
    cpu = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu = _to(cpu, "cuda")
    rng = np.random.RandomState(1)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, 48)))
    worst = 0.0
    lc, cc = prefill(cpu, {"tokens": toks}, cfg)
    before = ssd_ops.ssd_scan.launches
    lg, cg = prefill(gpu, {"tokens": toks.cuda()}, cfg)
    if ssd_ops.ssd_scan.launches != before + cfg.num_layers:
        raise AssertionError("the card's prefill did not launch the kernel")
    for step in range(5):
        if lg.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"logits {tuple(lg.shape)} not finite")
        err = float((lg.cpu() - lc).abs().max())
        worst = max(worst, err)
        if not torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"card vs CPU mamba2 logits at step {step}: "
                                 f"max_abs {err}")
        nxt = lc[:, 0].argmax(-1)
        lc, cc = decode_step(cpu, cc, nxt, cfg)
        lg, cg = decode_step(gpu, cg, nxt.cuda(), cfg)
    print(f"  fp32 small mamba2, card (SSD kernel) vs CPU (plain scan): "
          f"prefill + 4 decode steps, max_abs {worst:.3e} (tol 1e-4)")


def phase_serve_ssm():
    cfg = get_config("mamba2-370m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  mamba2-370m full width: {cfg.num_layers} SSD layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, "
          f"state {cfg.ssm_state}, {n_params / 1e9:.3f} B params in bf16, "
          f"init {time.perf_counter() - t0:.2f} s")
    max_len = max(SSM_PROMPT_LENS)
    engine = ServeEngine(cfg, params, max_len=max_len, num_slots=4)
    rng = np.random.RandomState(0)

    def make(n):
        return Request(prompt=rng.randint(1, cfg.vocab_size, (n,))
                       .astype(np.int32), max_new_tokens=MAX_NEW)

    engine.submit(make(64))  # warmup: first-call set-up outside the run
    engine.run_to_completion()
    torch.cuda.synchronize()
    engine.reset_stats()
    reqs = [make(n) for n in SSM_PROMPT_LENS]
    for r in reqs:
        engine.submit(r)

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = counts["ssd_scan"]

    if engine.truncated or len(done) != len(reqs):
        raise AssertionError(f"served {len(done)}/{len(reqs)} requests")
    for r in reqs:
        if len(r.generated) != MAX_NEW:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} "
                                 f"tokens, budget {MAX_NEW}")
    prefills = engine.counters["prefills"]
    if launches != prefills * cfg.num_layers or launches == 0:
        raise AssertionError(f"ssd_scan launches {launches} != prefills "
                             f"{prefills} x {cfg.num_layers} layers")
    if any(counts[name] for name in counts if name != "ssd_scan"):
        raise AssertionError(f"serve_ssm launched another kernel: {counts}")
    decode_tokens = engine.counters["decode_tokens"]
    print(f"  served {len(done)}/{len(reqs)} requests (prompts "
          f"{list(SSM_PROMPT_LENS)}, {MAX_NEW} new tokens each) in "
          f"{wall:.4f} s over {engine.counters['steps']} steps; peak device "
          f"memory {peak / 1e9:.3f} GB")
    print(f"  ssd_scan launches {launches} = {prefills} prefills x "
          f"{cfg.num_layers} layers")
    print(f"  decode: {decode_tokens} tokens, {decode_tokens / wall:.2f} "
          "tok/s over the run's wall clock; phase seconds " + ", ".join(
              f"{k}={v:.4f}" for k, v in engine.phase_seconds.items()))

    prefill_s = {}
    for n in SSM_PROMPT_LENS[::2] + (1024,):
        toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (1, n)),
                               device="cuda")
        run = lambda: prefill(params, {"tokens": toks}, cfg)
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        prefill_s[n] = (time.perf_counter() - t) / 3
    print("  prefill seconds by prompt length: " + ", ".join(
        f"{n}: {s:.5f}" for n, s in prefill_s.items()))

    # kernel path vs plain-version path: last-token prefill logits
    before = ssd_ops.ssd_scan.launches
    n = SSM_PROMPT_LENS[-1]
    toks = torch.as_tensor(reqs[-1].prompt, device="cuda")[None].long()
    got, gc = prefill(params, {"tokens": toks}, cfg)
    want, wc = prefill(params, {"tokens": toks}, cfg, force_ref=True)
    got, want = got.float(), want.float()
    if ssd_ops.ssd_scan.launches != before + cfg.num_layers:
        raise AssertionError("the kernel path did not launch the kernel")
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    if not (torch.isfinite(gc["ssm"]).all() and torch.isfinite(gc["conv"]
                                                               .float()).all()):
        raise AssertionError("prefill states not finite")
    rel = float((got - want).norm() / want.norm())
    print(f"  prefill logits, kernel vs plain path (prompt {n}): rel L2 "
          f"{rel:.3e} (tol {LOGIT_REL_TOL}), max_abs "
          f"{float((got - want).abs().max()):.3e}, max |logit| "
          f"{float(want.abs().max()):.3f}")
    if not rel <= LOGIT_REL_TOL:
        raise AssertionError(f"prefill logits disagree: rel L2 {rel}")
    del params, engine, gc, wc
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# RG-LRU scan (B7) and recurrentgemma serving
# ---------------------------------------------------------------------------
def lru_inputs(shape, gen, near_one=False):
    """a uniform in [0.2, 0.999] (as the JAX package's kernel tests), or
    within 1e-3 of 1 with ``near_one``; b gaussian."""
    dev = torch.device("cuda")
    u = torch.rand(shape, generator=gen, device=dev)
    a = 1.0 - 1e-3 * u if near_one else u.clamp(0.2, 0.999)
    return a, torch.randn(shape, generator=gen, device=dev)


def lru_near_one_check(name, a, b):
    """A long near-1 decay amplifies each step's fp32 rounding by up to
    1 / (1 - a), so two fp32 orders of the sums differ by far more than
    1e-5 there, and the fp32 sequential loop is no ground truth.  The
    kernel is held to the loop in fp64: no worse than twice the fp32
    loop's own error, plus 1e-5.  Returns the kernel's error."""
    got = lru_ops.lru_scan(a, b)
    exact = lru_ops.lru_sequential_ref(a.double(), b.double())
    err = float((got.double() - exact).abs().max())
    loop = float((lru_ops.lru_sequential_ref(a, b).double() - exact)
                 .abs().max())
    plain = float((lru_ops.lru_scan(a, b, force_ref=True).double() - exact)
                  .abs().max())
    limit = 2 * loop + LRU_TOL
    ok = err <= limit and bool(torch.isfinite(got).all())
    print(f"  check {tuple(a.shape)} {name} fp32: max_abs_err={err:.3e} vs "
          f"the loop in fp64 (the fp32 loop: {loop:.3e}, the plain version: "
          f"{plain:.3e}), max |h| {float(exact.abs().max()):.3f}, limit "
          f"{limit:.3e} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"lru_scan kernel drifts at {name}: {err}")
    return got


def phase_lru_kernel():
    gen = torch.Generator(device="cuda").manual_seed(6)
    max_err = 0.0
    for shape in LRU_TEST_SHAPES + LRU_SERVE_SHAPES + LRU_MORE_SHAPES:
        a, b = lru_inputs(shape, gen)
        got = lru_ops.lru_scan(a, b)
        torch.cuda.synchronize()
        want = lru_ops.lru_scan(a, b, force_ref=True)
        seq = lru_ops.lru_sequential_ref(a, b)
        err = float((got - want).abs().max())
        err_seq = float((got - seq).abs().max())
        ok = (torch.allclose(got, want, atol=LRU_TOL, rtol=LRU_TOL)
              and torch.allclose(got, seq, atol=LRU_TOL, rtol=LRU_TOL)
              and bool(torch.isfinite(got).all()))
        print(f"  check {shape} fp32: max_abs_err={err:.3e} vs plain, "
              f"{err_seq:.3e} vs the "
              f"sequential loop (max |h| {float(seq.abs().max()):.3f}), "
              f"tol {LRU_TOL} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"lru_scan kernel disagrees at {shape}: "
                                 f"max_abs_err={err}, {err_seq}")
        max_err = max(max_err, err)
    # near-1 decays at the longest serve prompt: a within 1e-3 of 1 with
    # gaussian b (h a random walk), and the JAX package's stability test
    # (tests/test_kernels.py:90: a = 0.999, b = 0.01, |h| below
    # b / (1 - a)) at 5x its length and every serve channel
    lru_near_one_check("a near 1", *lru_inputs((1, 2560, 4096), gen, True))
    shape = (1, 2560, 4096)
    got = lru_near_one_check(
        "a = 0.999, b = 0.01", torch.full(shape, 0.999, device="cuda"),
        torch.full(shape, 0.01, device="cuda"))
    if not float(got.abs().max()) <= 0.01 / (1 - 0.999) + 1e-3:
        raise AssertionError("lru_scan: |h| above b / (1 - a)")

    # one pass with a look-back carry: the same fmafs in the same order
    # wherever a look-back stops, so h is bitwise the same every call
    shape = (1, 2560, 4096)
    a, b = lru_inputs(shape, gen)
    first = lru_ops.lru_scan(a, b)
    same = all(torch.equal(first, lru_ops.lru_scan(a, b)) for _ in range(4))
    print(f"  check {shape} five calls bitwise equal: "
          f"{'ok' if same else 'MISMATCH'}")
    if not same:
        raise AssertionError("lru_scan: two calls differ")
    for shape in (LRU_SERVE_SHAPES[0], LRU_SERVE_SHAPES[-1]):
        a, b = lru_inputs(shape, gen)
        n, times = cuda_launches(lambda: lru_ops.lru_scan(a, b))
        print(f"  CUDA launches per call at S={shape[1]}: {n:g} (profiler, "
              "by name: launches x device us per call: " + ", ".join(
                  f"{k} {c:g} x {us:.2f}" for k, (c, us) in times.items())
              + ")")

    rows = {}
    for shape in LRU_SERVE_SHAPES:
        a, b = lru_inputs(shape, gen)
        kern = lambda: lru_ops.lru_scan(a, b)
        plain = lambda: lru_ops.lru_scan(a, b, force_ref=True)
        ms, plain_ms = card_ms(kern, 20), card_ms(plain, 3)
        # one elementwise call that moves the same bytes: a practical roof
        # for any one pass over a and b
        h = torch.empty_like(a)
        roof_ms = card_ms(lambda: torch.add(a, b, out=h), 20)
        B, S, C = shape
        nbytes = 12 * B * S * C  # a and b read once, h written once
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2 * B * S * C / PEAK_FLOPS[torch.float32] * 1e3
        rows[S] = dict(ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
        print(f"  time {shape} fp32 (card, graph replay): kernel {ms:.5f} "
              f"ms, plain {plain_ms:.5f} ms, bound {t_bytes:.5f} ms (bytes: "
              f"{nbytes} bytes; the {2 * B * S * C} flops take "
              f"{t_ops:.5f} ms) -> {nbytes / ms / 1e6:.1f} GB/s, "
              f"{t_bytes / ms:.2%} of the bound; torch.add of the same "
              f"bytes {roof_ms:.5f} ms")
    return max_err, rows


def hybrid_reference_cfg():
    """recurrentgemma's smoke config (RG-LRU, RG-LRU, local attention, two
    more RG-LRU layers) in fp32 at head_dim 256, the kernel's instance."""
    return dataclasses.replace(
        get_config("recurrentgemma-9b", smoke=True), dtype="float32",
        param_dtype="float32", d_model=128, num_heads=2, num_kv_heads=1,
        head_dim=256, lru_width=96, local_window=16)


def phase_reference_hybrid():
    """A small fp32 recurrentgemma on the card against the same model on
    the CPU: prefill of 40 tokens (past the window of 16) and 4 decode
    steps that wrap the ring.  The card's scan and attention are B7 and
    B5b, the CPU's their plain versions; TF32 is off, so the logits agree
    to fp32 rounding (1e-4, the differential tests' tolerance)."""
    cfg = hybrid_reference_cfg()
    cpu = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu = _to(cpu, "cuda")
    kinds = [kind for kind, _ in layer_slots(cfg)]
    n_lru, n_attn = kinds.count("rglru"), kinds.count("attn_local")
    rng = np.random.RandomState(1)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, 40)))
    worst = 0.0
    lc, cc = prefill(cpu, {"tokens": toks}, cfg, max_len=48)
    before = (lru_ops.lru_scan.launches, flash_ops.flash_attention.launches)
    lg, cg = prefill(gpu, {"tokens": toks.cuda()}, cfg, max_len=48)
    after = (lru_ops.lru_scan.launches, flash_ops.flash_attention.launches)
    if (after[0] - before[0], after[1] - before[1]) != (n_lru, n_attn):
        raise AssertionError("the card's prefill did not launch the kernels")
    for step in range(5):
        if lg.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"logits {tuple(lg.shape)} not finite")
        err = float((lg.cpu() - lc).abs().max())
        worst = max(worst, err)
        if not torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"card vs CPU recurrentgemma logits at step "
                                 f"{step}: max_abs {err}")
        nxt = lc[:, 0].argmax(-1)
        lc, cc = decode_step(cpu, cc, nxt, cfg)
        lg, cg = decode_step(gpu, cg, nxt.cuda(), cfg)
    print(f"  fp32 small recurrentgemma ({n_lru} RG-LRU, {n_attn} local "
          f"attention layers at head_dim 256), card (B7 + B5b) vs CPU "
          f"(plain versions): prefill + 4 decode steps, max_abs {worst:.3e} "
          "(tol 1e-4)")


def phase_serve_hybrid():
    cfg = get_config("recurrentgemma-9b")
    kinds = [kind for kind, _ in layer_slots(cfg)]
    n_lru, n_attn = kinds.count("rglru"), kinds.count("attn_local")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    weights = torch.cuda.memory_allocated()
    print(f"  recurrentgemma-9b full width: {cfg.num_layers} layers "
          f"({n_lru} RG-LRU of width {cfg.lru_width}, {n_attn} local "
          f"attention of {cfg.num_heads} heads x {cfg.head_dim} over "
          f"{cfg.num_kv_heads} KV head, window {cfg.local_window}), d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params in bf16 "
          f"({weights / 1e9:.3f} GB), init {time.perf_counter() - t0:.2f} s")
    engine = ServeEngine(cfg, params, max_len=HYBRID_MAX_LEN, num_slots=4)
    rng = np.random.RandomState(0)

    def make(n):
        return Request(prompt=rng.randint(1, cfg.vocab_size, (n,))
                       .astype(np.int32), max_new_tokens=MAX_NEW)

    engine.submit(make(64))  # warmup: first-call set-up outside the run
    engine.run_to_completion()
    torch.cuda.synchronize()
    engine.reset_stats()
    reqs = [make(n) for n in HYBRID_PROMPT_LENS]
    for r in reqs:
        engine.submit(r)

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    if engine.truncated or len(done) != len(reqs):
        raise AssertionError(f"served {len(done)}/{len(reqs)} requests")
    for r in reqs:
        if len(r.generated) != MAX_NEW:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} "
                                 f"tokens, budget {MAX_NEW}")
    prefills = engine.counters["prefills"]
    want = {name: 0 for name in counts}
    want.update(lru_scan=prefills * n_lru, flash_attention=prefills * n_attn)
    if counts != want or prefills == 0:
        raise AssertionError(f"serve_hybrid launches {counts}, expected "
                             f"{want} ({prefills} prefills)")
    decode_tokens = engine.counters["decode_tokens"]
    print(f"  served {len(done)}/{len(reqs)} requests (prompts "
          f"{list(HYBRID_PROMPT_LENS)}, {MAX_NEW} new tokens each, max_len "
          f"{HYBRID_MAX_LEN}) in {wall:.4f} s over {engine.counters['steps']} "
          f"steps; peak device memory {peak / 1e9:.3f} GB")
    print(f"  lru_scan launches {counts['lru_scan']} = {prefills} prefills x "
          f"{n_lru} RG-LRU layers; flash_attention launches "
          f"{counts['flash_attention']} = {prefills} prefills x {n_attn} "
          "attention layers")
    print(f"  decode: {decode_tokens} tokens, {decode_tokens / wall:.2f} "
          "tok/s over the run's wall clock; phase seconds " + ", ".join(
              f"{k}={v:.4f}" for k, v in engine.phase_seconds.items()))

    prefill_s = {}
    for n in HYBRID_PROMPT_LENS:
        toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (1, n)),
                               device="cuda")
        run = lambda: prefill(params, {"tokens": toks}, cfg,
                              max_len=HYBRID_MAX_LEN)
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        prefill_s[n] = (time.perf_counter() - t) / 3
    print("  prefill seconds by prompt length: " + ", ".join(
        f"{n}: {s:.5f}" for n, s in prefill_s.items()))

    # kernel path vs plain-version path: last-token prefill logits, with
    # the bf16 weights, then with the same weights in fp32
    n = HYBRID_PROMPT_LENS[-1]
    toks = torch.as_tensor(reqs[-1].prompt, device="cuda")[None].long()
    got, want = hybrid_logits(params, cfg, toks, n_lru, n_attn)
    del engine
    _to_fp32_in_place(params)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    got32, want32 = hybrid_logits(params, cfg32, toks, n_lru, n_attn)
    rel = lambda x, y: float((x - y).norm() / y.norm())
    rel32, rel16 = rel(got32, want32), rel(got, want)
    noise, got_noise = rel(want, want32), rel(got, want32)
    print(f"  prefill logits, kernel vs plain path (prompt {n}): fp32 "
          f"weights rel L2 {rel32:.3e} (tol {FP32_LOGIT_REL_TOL}), max_abs "
          f"{float((got32 - want32).abs().max()):.3e}; bf16 rel L2 "
          f"{rel16:.3e} (tol: the bf16 plain path's distance from the fp32 "
          f"plain path, {noise:.3e}; the bf16 kernel path's {got_noise:.3e}),"
          f" max |logit| {float(want.abs().max()):.3f}, same argmax "
          f"{bool(got.argmax() == want.argmax())}")
    if not (rel32 <= FP32_LOGIT_REL_TOL and rel16 <= noise):
        raise AssertionError(f"prefill logits disagree: rel L2 {rel32} "
                             f"(fp32), {rel16} (bf16, limit {noise})")
    del params
    torch.cuda.empty_cache()
    return counts


def hybrid_logits(params, cfg, toks, n_lru, n_attn):
    """Last-token prefill logits through the kernels (which must launch
    once per layer) and through their plain versions, in fp32."""
    before = (lru_ops.lru_scan.launches, flash_ops.flash_attention.launches)
    got, gc = prefill(params, {"tokens": toks}, cfg, max_len=HYBRID_MAX_LEN)
    after = (lru_ops.lru_scan.launches, flash_ops.flash_attention.launches)
    want, _ = prefill(params, {"tokens": toks}, cfg, max_len=HYBRID_MAX_LEN,
                      force_ref=True)
    if (after[0] - before[0], after[1] - before[1]) != (n_lru, n_attn):
        raise AssertionError("the kernel path did not launch the kernels")
    if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    if not all(torch.isfinite(gc[k].float()).all() for k in gc):
        raise AssertionError("prefill caches not finite")
    return got.float(), want.float()


def _to_fp32_in_place(tree):
    """Every tensor of a parameter tree in fp32, leaf by leaf, so the bf16
    and fp32 copies of the whole model are never both held."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            _to_fp32_in_place(leaf)
        else:
            tree[key] = leaf.float()


def ptxas_by_kernel(log: str, names) -> dict:
    """``{name: (registers, spill stores, spill loads)}`` from a
    ``-Xptxas -v`` report, for the kernels whose mangled names hold one
    of ``names`` (registers None where the report gives none)."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        if "Function properties for " in line:
            mangled = line.split("Function properties for ", 1)[1]
            name = next((n for n in names if n in mangled), None)
            spill = (0, 0)
        elif name is not None and "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            spill = (int(found[1]), int(found[2]))
            out[name] = (None,) + spill
        elif name is not None and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            out[name] = (regs,) + spill
            name = None
    return out


def check_spills(label: str, log: str, gated, shown=()) -> None:
    """Print the registers and spills of the kernels ``gated`` and
    ``shown`` in a ``-Xptxas -v`` report; fail unless each kernel of
    ``gated`` is in it with no spill.  The gated kernels are built to keep
    their working set in registers and shared memory: a spill would move
    it through local memory (B7: the second read of a and b that its one
    pass removes; B6's ``ssd_chunk_out`` runs one register below its cap
    of 128, so a later edit could tip it over)."""
    report = ptxas_by_kernel(log, tuple(gated) + tuple(shown))
    for name, (regs, st, ld) in report.items():
        print(f"  {label} {name}: {regs} registers, {st} bytes spill "
              f"stores, {ld} bytes spill loads")
    missing = [n for n in gated if n not in report]
    if missing:
        raise AssertionError(f"{label}: expected {len(gated)} kernels in "
                             f"the ptxas report, missing {missing}")
    spilled = {n: report[n][1:] for n in gated if report[n][1:] != (0, 0)}
    if spilled:
        raise AssertionError(f"{label}: ptxas reports spills (stores, "
                             f"loads) in {spilled}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    sources = (flash_ops.SOURCE, ring_ops.SOURCE, ring_ops.DEVICE_SOURCE,
               ssd_ops.SOURCE, lru_ops.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        recs = list(pool.map(build, sources))
    for source, rec in zip(sources, recs):
        print(f"[build] {source.name} in {rec['seconds']:.2f} s")
        lines = {}
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                lines[line.strip()] = lines.get(line.strip(), 0) + 1
        for line, count in lines.items():
            print(f"  {line}" + (f" (x{count})" if count > 1 else ""))
        if source == flash_ops.SOURCE:
            check_spills("B5", rec["log"], FLASH_TC_KERNELS)
        if source == ssd_ops.SOURCE:
            check_spills("B6", rec["log"], SSD_KERNELS[:3], SSD_KERNELS[3:])
        if source == lru_ops.SOURCE:
            check_spills("B7", rec["log"], LRU_KERNELS)

    print("[kernels]")
    max_err, rows, rows256 = phase_kernels()
    print("[ring-kernels]")
    ring_rows = phase_ring_kernels()
    # launches of each main path, every counter set to 0 just before it
    # ran and read just after
    paths = {}
    print("[allreduce]")
    paths["allreduce"] = phase_allreduce()
    print("[device-ring-kernels]")
    device_rows = phase_device_ring_kernels()
    print("[allreduce-device]")
    paths["allreduce_device"] = phase_allreduce_device()
    print("[sort]")
    paths["sort"] = phase_sort()
    print("[serve]")
    phase_reference()
    paths["serve"] = phase_serve()
    print("[ssd-kernel]")
    ssd_err, ssd_rows = phase_ssd_kernel()
    print("[serve-ssm]")
    phase_reference_ssm()
    paths["serve_ssm"] = phase_serve_ssm()
    print("[lru-kernel]")
    lru_err, lru_rows = phase_lru_kernel()
    print("[reference-hybrid]")
    phase_reference_hybrid()
    print("[serve-hybrid]")
    paths["serve_hybrid"] = phase_serve_hybrid()

    def launches(name, only=None):
        """The total over the paths (or the paths in ``only``) and each
        path's own count."""
        by_path = {path: c[name] for path, c in paths.items()
                   if only is None or path in only}
        return dict(launches=sum(by_path.values()),
                    launches_by_path=by_path)

    # B5 is listed once per head-dim group: its D = 64 and 128 instances
    # run on the dense serve path, its D = 256 instance (B5b) on
    # serve_hybrid; each row's times are at its own path's serve shape.
    flash = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:80")
    table = {"kernels": []}
    for dims, row in (((64, 128), rows[-1]), ((256,), rows256[0])):
        only = ("serve_hybrid",) if dims == (256,) else tuple(
            p for p in paths if p != "serve_hybrid")
        table["kernels"].append(dict(
            flash, head_dims=list(dims), **launches("flash_attention", only),
            max_abs_err=max_err[dims], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    for name, row in ring_rows.items():
        table["kernels"].append(dict(
            name=name, route="cuda", source=RING_SOURCE,
            replaces=RING_REPLACES[name], **launches(name), **row))
    for name, row in device_rows.items():
        table["kernels"].append(dict(
            name=name, route="cuda", source=DEVICE_SOURCE,
            replaces=DEVICE_REPLACES[name], **launches(name), **row))
    ssd_row = ssd_rows[-1]  # S = 1024, the longest serve prompt
    table["kernels"].append(dict(
        name="ssd_scan", route="cuda", source=SSD_SOURCE,
        replaces=SSD_REPLACES, **launches("ssd_scan"), max_abs_err=ssd_err,
        ms=ssd_row["ms"], plain_ms=ssd_row["plain_ms"],
        bound_ms=ssd_row["bound_ms"], bound_by=ssd_row["bound_by"],
        library_ms=None))
    lru_row = lru_rows[2048]  # the window of recurrentgemma-9b
    table["kernels"].append(dict(
        name="lru_scan", route="cuda", source=LRU_SOURCE,
        replaces=LRU_REPLACES, **launches("lru_scan"), max_abs_err=lru_err,
        ms=lru_row["ms"], plain_ms=lru_row["plain_ms"],
        bound_ms=lru_row["bound_ms"], bound_by=lru_row["bound_by"],
        library_ms=None))
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
