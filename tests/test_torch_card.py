"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
the hand-written kernels have no CPU mode.  The file imports only
``torch``, ``numpy``, ``pytest`` and ``repro_torch``, so it runs on a
machine with a card and no JAX, from the root of a checkout::

    PYTHONPATH=src python3 -m pytest -q tests/test_torch_card.py

Kernels and tolerances:

* B1/B2/B3/B4 ring collectives: bitwise (``torch.equal``);
* B5 flash attention at head_dim 64 and 128: 2e-5 in fp32, 3e-2 in bf16
  (tests/test_kernels.py:37,40); B5b at head_dim 256 (MQA 16:1 over a
  window, recurrentgemma's local attention): the same;
* B6 SSD scan: 3e-4 in fp32 (tests/test_kernels.py:71-72), 3e-2 in bf16;
* B7 RG-LRU scan: 1e-5 in fp32 (tests/test_kernels.py:86-87) against the
  plain doubling scan and the sequential loop, at the JAX package's test
  shapes, ragged S and C, and recurrentgemma-9b's serve shapes; a long
  near-1 decay against the loop in fp64 (see its test).

``chip_smoke.py`` makes the same checks at more shapes and times them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


# -- flash attention (B5, B5b) ------------------------------------------------
# (B, Sq, Skv, H, KV, D, causal, window)
FLASH_GRID = [
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 100, 100, 2, 2, 64, True, None),   # non-multiple -> padding
    (1, 64, 192, 4, 4, 64, False, None),   # cross-attention style
    (1, 128, 128, 8, 2, 128, True, 32),    # GQA 4:1, small window
]
# head_dim 256: recurrentgemma-9b's serve shape (MQA 16:1, window 2048),
# a window shorter than S, and a ragged S with GQA
FLASH_GRID_256 = [
    (1, 2048, 2048, 16, 1, 256, True, 2048),
    (1, 600, 600, 16, 1, 256, True, 256),
    (2, 130, 130, 4, 2, 256, True, None),
]
FLASH_TOLS = [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)]


def _flash_check(device, shape, dtype, tol):
    B, Sq, Skv, H, KV, D, causal, window = shape
    g = torch.Generator(device=device).manual_seed(Sq + D)
    q = torch.randn(B, Sq, H, D, generator=g, device=device).to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=g, device=device).to(dtype)
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_ops.flash_attention.launches == before + 1
    want = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     force_ref=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
def test_flash_kernel_matches_plain_version(cuda_device, dtype, tol):
    for shape in FLASH_GRID:
        _flash_check(cuda_device, shape, dtype, tol)


@pytest.mark.parametrize("shape", FLASH_GRID_256)
@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
def test_flash_kernel_head_dim_256(cuda_device, shape, dtype, tol):
    _flash_check(cuda_device, shape, dtype, tol)


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
