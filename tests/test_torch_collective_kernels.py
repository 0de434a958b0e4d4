"""The port's ring-collective plain versions against the JAX package.

Counterpart of ``tests/test_collective_kernels.py``.  The port's wrappers
(``repro_torch.kernels.collectives.ops``) compute their plain versions on
a CPU tensor; they are held, bit for bit, to the JAX package's Pallas
kernels in interpret mode and to its stacked NumPy oracles, for fp32,
int32 and bf16 at p ∈ {1, 2, 4, 8}: B1 reduce-scatter, B2 allgather, B3
allreduce (the B1+B2 composition) and B4 alltoall.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_card.py`` hold them to these plain versions bit for
bit).
"""
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.collectives import (  # noqa: E402
    ring_allgather_stacked,
    ring_allreduce_stacked,
    ring_alltoall_stacked,
    ring_reduce_scatter_stacked,
)
from repro.kernels.collectives import ref as jref  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels.collectives import ops, ref  # noqa: E402

PS = (1, 2, 4, 8)
DTYPES = ("float32", "int32", "bfloat16")


def data(p, shape, dtype, seed=0):
    rng = np.random.RandomState(seed + p)
    if dtype == "int32":
        return rng.randint(-50, 50, size=(p,) + shape).astype(np.int32)
    x = rng.randn(p, *shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def assert_bitwise(got, *wants):
    got = to_numpy(got)
    for want in wants:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_allgather_matches_kernel_and_oracle(p, dtype):
    xs = data(p, (3, 2), dtype)
    assert_bitwise(ops.ring_allgather(to_tensor(xs)),
                   ring_allgather_stacked(xs, interpret=True),
                   jref.allgather_stacked_ref(xs))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_reduce_scatter_matches_kernel_and_oracle_bitwise(p, dtype):
    """Float payloads included: the ring fold order is shared, so equality
    is bitwise, not allclose."""
    xs = data(p, (p, 5), dtype, seed=1)
    assert_bitwise(ops.ring_reduce_scatter(to_tensor(xs)),
                   ring_reduce_scatter_stacked(xs, interpret=True),
                   jref.reduce_scatter_stacked_ref(xs))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_allreduce_matches_kernel_and_oracle_bitwise(p, dtype):
    xs = data(p, (3, 7), dtype, seed=2)
    assert_bitwise(ops.ring_allreduce(to_tensor(xs)),
                   ring_allreduce_stacked(xs, interpret=True),
                   jref.allreduce_stacked_ref(xs))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_alltoall_matches_kernel_and_oracle(p, dtype):
    xs = data(p, (p, 2, 3), dtype, seed=3)
    assert_bitwise(ops.ring_alltoall(to_tensor(xs)),
                   ring_alltoall_stacked(xs, interpret=True),
                   jref.alltoall_stacked_ref(xs))


@pytest.mark.parametrize("p", PS)
def test_allreduce_chunk_small_payloads(p):
    """Payloads of 1, p-1 and p+1 elements go through the same
    pad/chunk/unpad as large ones (chunk 1 when n < p)."""
    for n in sorted({1, max(1, p - 1), p + 1}):
        assert ref.allreduce_chunk(n, p) == jref.allreduce_chunk(n, p)
        xs = data(p, (n,), "float32", seed=4 + n)
        assert_bitwise(ops.ring_allreduce(to_tensor(xs)),
                       ring_allreduce_stacked(xs, interpret=True),
                       jref.allreduce_stacked_ref(xs))


@pytest.mark.parametrize("p", (4, 8))
def test_bf16_reduce_scatter_rounds_after_every_add(p):
    """bf16 partial sums round to bf16 after every add, like the Pallas
    kernel's accumulator in the payload's dtype: on data where that differs
    from one rounding of the fp32 sum, the plain version matches the left
    fold and not the single rounding."""
    rng = np.random.RandomState(p)
    # 1 + small terms: each below half a bf16 ulp of the running sum, so
    # the left fold drops them one by one while their fp32 sum survives.
    xs = np.full((p, p, 64), 2.0 ** -9, np.float32)
    xs[:, :, :] *= rng.randint(1, 4, size=(p, p, 64))
    for r in range(p):
        xs[(r + 1) % p, r] = 1.0  # the first source of chunk r
    xs = xs.astype(ml_dtypes.bfloat16)
    got = ops.ring_reduce_scatter(to_tensor(xs))
    assert_bitwise(got, ring_reduce_scatter_stacked(xs, interpret=True),
                   jref.reduce_scatter_stacked_ref(xs))
    once = np.stack([xs[:, r].astype(np.float32).sum(0) for r in range(p)])
    assert (to_numpy(got).astype(np.float32)
            != once.astype(ml_dtypes.bfloat16).astype(np.float32)).any()


@pytest.mark.parametrize("p", (2, 4, 8))
def test_int32_sums_wrap(p):
    """Integer sums that overflow int32 wrap, as XLA and NumPy do."""
    xs = np.full((p, p, 3), 2 ** 31 - 7, np.int64).astype(np.int32)
    xs[:, :, 1] = -(2 ** 31)
    with np.errstate(over="ignore"):
        want = jref.reduce_scatter_stacked_ref(xs)
    assert_bitwise(ops.ring_reduce_scatter(to_tensor(xs)), want)
    assert_bitwise(ops.ring_allreduce(to_tensor(xs[:, 0])),
                   jref.allreduce_stacked_ref(xs[:, 0]))


@pytest.mark.parametrize("p", (2, 4, 8))
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_rings_are_independent_rings(p, dtype):
    """``rings=R`` runs R rings of length p/R over contiguous row blocks:
    each block's result is that block's own flat ring."""
    g, R = p // 2, 2
    xs = data(p, (g, 5), dtype, seed=6)
    rs = ops.ring_reduce_scatter(to_tensor(xs), rings=R)
    a2a = ops.ring_alltoall(to_tensor(xs), rings=R)
    ag = ops.ring_allgather(to_tensor(xs[:, 0]), rings=R)
    ar = ops.ring_allreduce(to_tensor(xs[:, 0]), rings=R)
    for b in range(R):
        blk = xs[b * g:(b + 1) * g]
        rows = slice(b * g, (b + 1) * g)
        assert_bitwise(rs[rows], jref.reduce_scatter_stacked_ref(blk))
        assert_bitwise(a2a[rows], jref.alltoall_stacked_ref(blk))
        assert_bitwise(ag[rows], jref.allgather_stacked_ref(blk[:, 0]))
        assert_bitwise(ar[rows], jref.allreduce_stacked_ref(blk[:, 0]))


def test_wrappers_take_cpu_or_cuda_only():
    x = torch.zeros(2, 2, 3, device="meta")
    for fn in (ops.ring_reduce_scatter, ops.ring_alltoall,
               ops.ring_allgather):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(x)
    with pytest.raises(ValueError, match="rings"):
        ops.ring_allgather(torch.zeros(3, 2), rings=2)
