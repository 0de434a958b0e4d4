#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit (nvidia-smi); TF32 off.
2. build — nvcc builds the serve path's kernel from the source in the
   checkout.
3. kernels — each kernel against its plain PyTorch version on the card,
   at the serve shapes and at GQA, window, ragged and non-causal shapes,
   in fp32 (2e-5) and bf16 (3e-2, and within half a bf16 ulp of the
   plain version in fp32); card times at the serve shapes (CUDA graph
   replay) beside the bound, the plain version and one PyTorch library
   call as a yardstick, and the same calls issued one by one from Python.
4. serve — full-width qwen1.5-0.5B in bf16 (random weights from a seeded
   ``torch.Generator``) answers 8 requests through
   ``repro_torch.serve.ServeEngine``; every launch counter is set to 0
   just before and read just after, and must show every kernel of the
   path launched (flash attention: prefills x 24 layers).  One request's
   prefill logits through the kernel match the plain-version path, and a
   small fp32 model on the card matches the same model on the CPU.

The last lines are the card's name and power limit, one JSON object with
the kernel table, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
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
]
TOLS = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# The kernel computes in fp32 and rounds its output to bf16 once, so each
# bf16 output lies within half a bf16 ulp (at most 2^-8 relative) of the
# plain version computed in fp32 on the same inputs, plus fp32 rounding.
BF16_HALF_ULP = 2.0 ** -8
BF16_FP32_ATOL = 1e-5
PROMPT_LENS = (100, 130, 200, 260, 300, 420, 520, 600)  # buckets 128..1024
MAX_NEW = 32
# bf16 prefill logits, kernel path vs plain-version path: both compute in
# fp32 and round to bf16, so an attention output differs by at most one
# bf16 ulp (2^-8 relative) where the two fp32 sums straddle a rounding
# boundary; 24 layers carry such flips into the logits at well under 2%.
LOGIT_REL_TOL = 2e-2


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
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
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
            max_err = max(max_err, err)

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
              f"bound {bound_ms:.5f} ms ({bound_by}) | issued from Python: "
              f"kernel {eager[0]:.5f}, plain {eager[1]:.5f}, sdpa "
              f"{eager[2]:.5f} ms")
    return max_err, rows


def phase_reference():
    """A small fp32 model on the card against the same model on the CPU:
    prefill (padded, with true_len) and 4 decode steps.  The card's prefill
    attention is the flash kernel, the CPU's the JAX package's CPU path
    (chunked attention); TF32 is off, so the logits agree to fp32
    rounding (1e-4, the differential tests' tolerance)."""
    import dataclasses

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

    flash_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_ops.flash_attention.launches

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
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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

    rec = build(flash_ops.SOURCE)
    print(f"[build] {flash_ops.SOURCE.name} in {rec['seconds']:.2f} s")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    print("[kernels]")
    max_err, rows = phase_kernels()
    print("[serve]")
    phase_reference()
    launches = phase_serve()

    main_row = rows[-1]  # the largest serve shape
    table = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:80",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
