"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
the hand-written kernels have no CPU mode.  The file imports only
``torch``, ``numpy``, ``pytest`` and ``repro_torch``, so it runs on a
machine with a card and no JAX, from the root of a checkout::

    PYTHONPATH=src python3 -m pytest -q tests/test_torch_card.py

Kernels and tolerances:

* B1/B2/B3/B4 ring collectives: bitwise (``torch.equal``);
* B8a/B8b per-device ring collectives on per-device ranks
  (``repro_torch.core.shard_map``): bitwise against their plain versions
  and B2/B1, one launch per rank per call, also with one rank slowed by a
  spin kernel on its stream and with neighbours whose inputs differ in
  16-byte alignment;
* B5 flash attention at head_dim 64 and 128: 2e-5 in fp32, 3e-2 in bf16
  (tests/test_kernels.py:37,40); B5b at head_dim 256 (MQA 16:1 over a
  window, recurrentgemma's local attention): the same; the bf16 kernel
  (tensor cores) also within half a bf16 ulp of the plain version in
  fp32, plus 1e-5;
* B6 SSD scan: 3e-4 in fp32 (tests/test_kernels.py:71-72), 3e-2 in bf16;
  the bf16 kernels (tensor cores, chunks in parallel) also within half a
  bf16 ulp of the plain version in fp32 plus 3e-4 (chip_smoke.py's bound)
  at the JAX package's kernel-test shapes, a 100-token chunk, Q, N and P
  off the mma tile, element-by-element loads (N, P not multiples of 8),
  two P tiles, and mamba2's serve shape with its fast decays;
* every kernel wrapper refuses, under grad mode, a CUDA input that
  requires grad (no backward yet, ROADMAP A2);
* B7 RG-LRU scan: 1e-5 in fp32 (tests/test_kernels.py:86-87) against the
  plain doubling scan and the sequential loop, at the JAX package's test
  shapes, ragged S and C, and recurrentgemma-9b's serve shapes; a long
  near-1 decay against the loop in fp64 (see its test).

``chip_smoke.py`` makes the same checks at more shapes and times them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import KampingError, shard_map  # noqa: E402
from repro_torch.core.spmd import bound_axis  # noqa: E402
from repro_torch.kernels.collectives import ops as ring_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rg_lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# -- ring collectives (B1, B2, B3, B4) ----------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_ring_kernels_match_plain_versions(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for p, m, rings in ((1, 7, 1), (3, 4099, 1), (4, 7, 2), (8, 4099, 1)):
        xs = torch.randint(-50, 50, (rings * p, p, m), generator=g,
                           device=cuda_device).to(dtype)
        for fn, x in ((ring_ops.ring_reduce_scatter, xs),
                      (ring_ops.ring_alltoall, xs),
                      (ring_ops.ring_allgather, xs[:, 0].contiguous()),
                      (ring_ops.ring_allreduce, xs[:, 0].contiguous())):
            assert torch.equal(fn(x, rings=rings),
                               fn(x, rings=rings, force_ref=True))


# -- per-device ring collectives (B8a, B8b) -----------------------------------
def _shifted(t, k):
    """A contiguous copy of ``t`` that starts ``k`` elements into a fresh
    buffer (k = 1: not 16-byte aligned)."""
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:]
    return out.view(t.shape).copy_(t)


def _b8(xs, slow=None, summable=True, offset=0):
    """B8a on slot 0 and B8b on the whole (p, m) of every rank, kernel and
    plain version, in one shard_map; rank ``slow`` first spins ~50 ms on
    its stream; the odd ranks' inputs start ``offset`` elements into their
    buffers."""
    def fn(v):
        ring = bound_axis("x").ranks
        if ring.rank == slow:
            torch.cuda._sleep(100_000_000)
        k = offset * (ring.rank % 2)
        v = _shifted(v, k)
        x0 = _shifted(v[0], k)
        outs = [ring_ops.device_ring_allgather(x0, ring),
                ring_ops.device_ring_allgather(x0, ring, force_ref=True)]
        if summable:
            outs += [ring_ops.device_ring_reduce_scatter(v, ring),
                     ring_ops.device_ring_reduce_scatter(v, ring,
                                                         force_ref=True)]
        return tuple(outs)

    return shard_map(fn, xs, timeout=60)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
def test_device_ring_kernels_match_plain_versions(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    summable = dtype != torch.uint8
    for p, m in ((2, 7), (3, 4099), (4, 1 << 16), (8, 1)):
        xs = torch.randint(0, 100, (p, p, m), generator=g,
                           device=cuda_device).to(dtype)
        before = (ring_ops.device_ring_allgather.launches,
                  ring_ops.device_ring_reduce_scatter.launches)
        outs = _b8(xs, summable=summable)
        assert ring_ops.device_ring_allgather.launches == before[0] + p
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(outs[0], ring_ops.ring_allgather(
            xs[:, 0].contiguous(), force_ref=not summable))
        if summable:
            assert ring_ops.device_ring_reduce_scatter.launches == \
                before[1] + p
            assert torch.equal(outs[2], outs[3])
            assert torch.equal(outs[2], ring_ops.ring_reduce_scatter(xs))


@pytest.mark.parametrize("slow", [0, 3])
def test_device_ring_kernels_with_a_slowed_rank(cuda_device, slow):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    xs = torch.randn((4, 4, 1 << 20), generator=g, device=cuda_device)
    outs = _b8(xs, slow=slow)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[2], outs[3])
    assert torch.equal(outs[2], ring_ops.ring_reduce_scatter(xs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_device_ring_kernels_with_misaligned_neighbours(cuda_device, dtype):
    """Rank 0's input is 16-byte aligned and rank 1's is not: the ranks
    must agree on the load width, or block b of one rank and of its
    neighbour would cover different ranges."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    summable = dtype != torch.uint8
    for p in (2, 4):
        xs = torch.randint(0, 100, (p, p, 1 << 16), generator=g,
                           device=cuda_device).to(dtype)
        outs = _b8(xs, summable=summable, offset=1)
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(outs[0], ring_ops.ring_allgather(
            xs[:, 0].contiguous(), force_ref=not summable))
        if summable:
            assert torch.equal(outs[2], outs[3])
            assert torch.equal(outs[2], ring_ops.ring_reduce_scatter(xs))


def test_device_ring_spin_that_runs_out_raises(cuda_device, monkeypatch):
    """With every spin bounded at 5 ms, a rank slowed by ~50 ms makes its
    neighbours' spins run out: shard_map raises instead of hanging or
    returning the result."""
    monkeypatch.setattr(ring_ops, "SPIN_TIMEOUT_S", 0.005)
    xs = torch.zeros((4, 4, 1 << 20), device=cuda_device)
    with pytest.raises(KampingError, match="spin ran out"):
        _b8(xs, slow=1)


# -- flash attention (B5, B5b) ------------------------------------------------
# (B, Sq, Skv, H, KV, D, causal, window)
# The bf16 kernel works on 128-row q tiles and 64-key KV tiles (TMA boxes
# zero-filled past Sq and Skv), so the grid holds lengths that are not
# multiples of either.
FLASH_GRID = [
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 100, 100, 2, 2, 64, True, None),   # non-multiple -> padding
    (1, 64, 192, 4, 4, 64, False, None),   # cross-attention style
    (1, 128, 128, 8, 2, 128, True, 32),    # GQA 4:1, small window
    (2, 200, 200, 4, 2, 64, True, None),   # 200: neither 64k nor 128k
    (1, 200, 328, 4, 4, 64, False, None),  # Skv != Sq, both ragged
    (1, 128, 128, 4, 4, 64, True, 0),      # window 0: every row masked
    (2, 256, 256, 8, 2, 128, True, None),  # GQA 8:2 at head_dim 128
    (1, 300, 130, 8, 2, 128, False, None),  # Skv < Sq, non-causal
]
# head_dim 256: recurrentgemma-9b's serve shape (MQA 16:1, window 2048),
# a window shorter than S, a ragged S with GQA, S one past a q tile,
# batch 2 with MQA, Skv != Sq and window 0
FLASH_GRID_256 = [
    (1, 2048, 2048, 16, 1, 256, True, 2048),
    (1, 600, 600, 16, 1, 256, True, 256),
    (2, 130, 130, 4, 2, 256, True, None),
    (1, 2049, 2049, 16, 1, 256, True, None),
    (2, 300, 300, 16, 1, 256, True, 256),
    (1, 130, 260, 4, 1, 256, False, None),
    (1, 64, 64, 4, 1, 256, True, 0),
]
FLASH_TOLS = [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)]
# The bf16 kernel computes in fp32 (P as two bf16 halves on the tensor
# cores) and rounds its output once, so each output lies within half a
# bf16 ulp (at most 2^-8 relative) of the plain version computed in fp32
# on the same inputs, plus fp32 rounding (chip_smoke.py holds the same).
BF16_HALF_ULP, BF16_FP32_ATOL = 2.0 ** -8, 1e-5


def _flash_inputs(device, shape, dtype):
    B, Sq, Skv, H, KV, D, _, _ = shape
    g = torch.Generator(device=device).manual_seed(Sq + D)
    q = torch.randn(B, Sq, H, D, generator=g, device=device).to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=g, device=device).to(dtype)
    return q, k, v


def _flash_check(device, shape, dtype, tol):
    causal, window = shape[6], shape[7]
    q, k, v = _flash_inputs(device, shape, dtype)
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_ops.flash_attention.launches == before + 1
    want = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     force_ref=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if window == 0:  # every key masked: the output is exactly 0
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
def test_flash_kernel_matches_plain_version(cuda_device, dtype, tol):
    for shape in FLASH_GRID:
        _flash_check(cuda_device, shape, dtype, tol)


@pytest.mark.parametrize("shape", FLASH_GRID_256)
@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
def test_flash_kernel_head_dim_256(cuda_device, shape, dtype, tol):
    _flash_check(cuda_device, shape, dtype, tol)


@pytest.mark.parametrize("shape", FLASH_GRID + FLASH_GRID_256)
def test_flash_bf16_within_half_ulp_of_fp32(cuda_device, shape):
    """The bf16 kernel against the plain version in fp32 on the same bf16
    inputs: |got - want| <= 2^-8 |want| + 1e-5 everywhere."""
    causal, window = shape[6], shape[7]
    q, k, v = _flash_inputs(cuda_device, shape, torch.bfloat16)
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_ops.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal, window=window,
                                     force_ref=True)
    excess = (got.float() - want).abs() - BF16_HALF_ULP * want.abs()
    assert float(excess.max()) <= BF16_FP32_ATOL


# -- SSD scan (B6) ------------------------------------------------------------
def _ssd_inputs(B, S, H, P, G, N, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32) * 0.5
    a = np.clip(rng.rand(B, S, H).astype(np.float32), 0.3, 0.99)
    Bm = rng.randn(B, S, G, N).astype(np.float32) * 0.3
    C = rng.randn(B, S, G, N).astype(np.float32) * 0.3
    return [torch.as_tensor(v) for v in (x, a, Bm, C)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 3e-2)])
def test_ssd_kernel_matches_plain_version(cuda_device, dtype, tol):
    x, a, Bm, C = (v.to(cuda_device)
                   for v in _ssd_inputs(1, 256, 32, 64, 1, 128))
    x, Bm, C = (v.to(dtype) for v in (x, Bm, C))
    before = ssd_ops.ssd_scan.launches
    got = ssd_ops.ssd_scan(x, a, Bm, C, chunk=128)
    assert ssd_ops.ssd_scan.launches == before + 1
    want = ssd_ops.ssd_scan(x, a, Bm, C, chunk=128, force_ref=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (B, S, H, P, G, N, chunk): the JAX package's kernel-test shapes
# (tests/test_kernels.py), one chunk of 100 tokens at mamba2's widths, Q,
# N and P all off the 16 x 8 mma tile, N and P not multiples of 8 (the
# element-by-element loads), and P over two 64-column tiles
SSD_BF16_SHAPES = [(2, 64, 4, 16, 1, 32, 16), (1, 128, 2, 32, 2, 16, 32),
                   (1, 64, 8, 8, 1, 8, 64), (2, 96, 4, 16, 4, 16, 32),
                   (1, 100, 32, 64, 1, 128, 128), (2, 300, 6, 24, 3, 40, 100),
                   (1, 96, 4, 12, 2, 20, 48), (1, 128, 2, 80, 1, 16, 64)]
SSD_TOL, BF16_HALF_ULP = 3e-4, 2.0 ** -8


@pytest.mark.parametrize("shape,fast", [(s, False) for s in SSD_BF16_SHAPES]
                         + [((1, 1024, 32, 64, 1, 128, 128), True)])
def test_ssd_bf16_within_half_ulp_of_fp32(cuda_device, shape, fast):
    """|got - want| <= 2^-8 |want| + 3e-4 against the plain version in fp32
    on the same bf16 inputs; ``fast``: every other head decays as
    exp(-(4 + 16 u)), mamba2's fast heads."""
    B, S, H, P, G, N, chunk = shape
    x, a, Bm, C = (v.to(cuda_device)
                   for v in _ssd_inputs(B, S, H, P, G, N, seed=sum(shape)))
    if fast:
        g = torch.Generator(device=cuda_device).manual_seed(9)
        u = torch.rand(B, S, (H + 1) // 2, generator=g, device=cuda_device)
        a[:, :, ::2] = torch.exp(-(4 + 16 * u))
    x, Bm, C = (v.to(torch.bfloat16) for v in (x, Bm, C))
    before = ssd_ops.ssd_scan.launches
    got = ssd_ops.ssd_scan(x, a, Bm, C, chunk=chunk)
    assert ssd_ops.ssd_scan.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = ssd_ops.ssd_scan(x.float(), a, Bm.float(), C.float(), chunk=chunk,
                            force_ref=True)
    excess = (got.float() - want).abs() - BF16_HALF_ULP * want.abs()
    assert bool(torch.isfinite(got.float()).all())
    assert float(excess.max()) <= SSD_TOL


# -- autograd: the CUDA route refuses what it would cut (C8) -----------------
def _grad_calls(device):
    q = torch.zeros(1, 8, 2, 64, device=device, requires_grad=True)
    kv = torch.zeros(1, 8, 1, 64, device=device)
    x = torch.zeros(1, 16, 2, 8, device=device, requires_grad=True)
    a = torch.full((1, 16, 2), 0.5, device=device)
    bm = torch.zeros(1, 16, 1, 8, device=device)
    la = torch.full((1, 16, 4), 0.5, device=device)
    lb = torch.zeros(1, 16, 4, device=device, requires_grad=True)
    return {"flash_attention": lambda: flash_ops.flash_attention(q, kv, kv),
            "ssd_scan": lambda: ssd_ops.ssd_scan(x, a, bm, bm, chunk=8),
            "lru_scan": lambda: lru_ops.lru_scan(la, lb)}


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan", "lru_scan"])
def test_wrapper_refuses_cuda_input_that_requires_grad(cuda_device, name):
    call = _grad_calls(cuda_device)[name]
    with pytest.raises(KampingError, match="ROADMAP A2"):
        call()
    with torch.no_grad():  # no graph to cut: the kernel runs
        assert call().grad_fn is None


# -- RG-LRU scan (B7) ---------------------------------------------------------
LRU_TOL = 1e-5
# (B, S, C): tests/test_kernels.py:77-78, ragged S and C, and
# recurrentgemma-9b's serve shapes (C = lru_width = 4096)
LRU_SHAPES = [(2, 64, 32), (1, 128, 64), (1, 32, 128), (3, 64, 32),
              (1, 100, 48), (3, 37, 5), (2, 1, 7), (3, 1000, 4100),
              (1, 100, 4096), (1, 2048, 4096), (1, 2560, 4096)]


@pytest.mark.parametrize("shape", LRU_SHAPES)
def test_lru_kernel_matches_plain_version(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    a = torch.rand(shape, generator=g, device=cuda_device).clamp(0.2, 0.999)
    b = torch.randn(shape, generator=g, device=cuda_device)
    before = lru_ops.lru_scan.launches
    got = lru_ops.lru_scan(a, b)
    assert lru_ops.lru_scan.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == a.shape
    want = lru_ops.lru_scan(a, b, force_ref=True)
    torch.testing.assert_close(got, want, atol=LRU_TOL, rtol=LRU_TOL)
    seq = lru_ops.lru_sequential_ref(a, b)
    torch.testing.assert_close(got, seq, atol=LRU_TOL, rtol=LRU_TOL)


def test_lru_kernel_decay_stability_long_sequence(cuda_device):
    """a = 0.999 over 4096 steps, 64 kernel chunks (tests/test_kernels.py:90
    at 8x its length): finite and bounded by b / (1 - a), as the reference
    asserts.  Near the fixed point each step's fp32 rounding is amplified
    by 1 / (1 - a) = 1000, so two fp32 orders of the sums differ by far
    more than 1e-5 there: the kernel is held to the loop in fp64, no worse
    than twice the fp32 loop's own error plus 1e-5."""
    a = torch.full((1, 4096, 64), 0.999, device=cuda_device)
    b = torch.full((1, 4096, 64), 0.01, device=cuda_device)
    got = lru_ops.lru_scan(a, b)
    assert bool(torch.isfinite(got).all())
    assert float(got.abs().max()) <= 0.01 / (1 - 0.999) + 1e-3
    exact = lru_ops.lru_sequential_ref(a.double(), b.double())
    loop = float((lru_ops.lru_sequential_ref(a, b).double() - exact)
                 .abs().max())
    assert float((got.double() - exact).abs().max()) <= 2 * loop + LRU_TOL
