"""The per-device ring collectives B8a/B8b (``ops.device_ring_allgather``,
``ops.device_ring_reduce_scatter``) on per-device ranks, through their
plain versions (``kernels/collectives/ref.py``), on the CPU.

* Against the JAX package's SPMD ring references
  (``repro.kernels.collectives.ref.ring_allgather`` / ``ring_reduce_scatter``
  / ``ring_allreduce``) run under ``jax.vmap(axis_name=)``: bit for bit,
  on exact payloads (integers, dyadic fp32), at p in {1, 2, 3, 4, 8}.
* Against the port's stacked plain versions of B2/B1/B3: bit for bit on
  random fp32, since B8b folds every chunk in B1's order.
* A slowed rank gives the same answer; a rank that raises and a rank that
  never arrives make ``shard_map`` raise within its timeout.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro.kernels.collectives import ref as jref  # noqa: E402
from repro_torch.core.spmd import bound_axis  # noqa: E402
from repro_torch.kernels.collectives import ops as ring_ops  # noqa: E402
from repro_torch.kernels.collectives import ref as tref  # noqa: E402

PS = (1, 2, 3, 4, 8)
TIMEOUT = 30.0


def exact(p, shape, dtype, seed):
    """Exact payloads: integers in [-50, 50), or dyadic fp32 (multiples of
    1/16 up to 32) whose partial sums are exact in any order."""
    rng = np.random.RandomState(seed * 100 + p)
    if dtype == "dyadic":
        return (rng.randint(-512, 513, size=(p,) + shape) / 16.0).astype(
            np.float32)
    return rng.randint(-50, 50, size=(p,) + shape).astype(dtype)


def per_device(fn, xs, timeout=TIMEOUT):
    """``fn(v, ring)`` on every rank of a CPU shard_map."""
    return tc.shard_map(lambda v: fn(v, bound_axis("x").ranks),
                        torch.as_tensor(xs), device="cpu", timeout=timeout)


def jax_spmd(fn, xs):
    return np.asarray(jax.vmap(fn, axis_name="x")(jnp.asarray(xs)))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", ["dyadic", np.int32, np.int64])
def test_plain_b8_match_the_jax_spmd_references(p, dtype):
    x = exact(p, (5, 3), dtype, seed=1)
    got = per_device(ring_ops.device_ring_allgather, x)
    np.testing.assert_array_equal(
        got.numpy(), jax_spmd(lambda v: jref.ring_allgather(v, "x", p), x))

    xs = exact(p, (p, 4, 3), dtype, seed=2)
    got = per_device(ring_ops.device_ring_reduce_scatter, xs)
    np.testing.assert_array_equal(
        got.numpy(),
        jax_spmd(lambda v: jref.ring_reduce_scatter(v, "x", p), xs))

    x = exact(p, (13,), dtype, seed=3)  # 13 elements: padded chunks
    got = per_device(ring_ops.device_ring_allreduce, x)
    np.testing.assert_array_equal(
        got.numpy(), jax_spmd(lambda v: jref.ring_allreduce(v, "x", p), x))


@pytest.mark.parametrize("p", PS)
def test_plain_b8_match_stacked_b2_b1_b3_on_random_fp32(p):
    rng = np.random.RandomState(p)
    x = torch.as_tensor(rng.randn(p, 7, 2).astype(np.float32))
    assert torch.equal(per_device(ring_ops.device_ring_allgather, x),
                       tref.allgather_stacked_ref(x))
    xs = torch.as_tensor(rng.randn(p, p, 9).astype(np.float32))
    assert torch.equal(per_device(ring_ops.device_ring_reduce_scatter, xs),
                       tref.reduce_scatter_stacked_ref(xs))
    x = torch.as_tensor(rng.randn(p, 11).astype(np.float32))
    assert torch.equal(per_device(ring_ops.device_ring_allreduce, x),
                       tref.allreduce_stacked_ref(x))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float64, torch.bool])
def test_plain_allgather_moves_any_dtype(dtype):
    x = torch.as_tensor(np.random.RandomState(0).randint(0, 2, (4, 6))).to(
        dtype)
    assert torch.equal(per_device(ring_ops.device_ring_allgather, x),
                       tref.allgather_stacked_ref(x))


@pytest.mark.parametrize("slow", [0, 2])
def test_a_slowed_rank_gives_the_same_answer(slow):
    p = 4
    xs = torch.as_tensor(np.random.RandomState(5).randn(p, p, 8).astype(
        np.float32))

    def fn(v, ring):
        if ring.rank == slow:
            time.sleep(0.2)
        return ring_ops.device_ring_reduce_scatter(v, ring)

    assert torch.equal(per_device(fn, xs), tref.reduce_scatter_stacked_ref(xs))

    def ag(v, ring):
        if ring.rank == slow:
            time.sleep(0.2)
        return ring_ops.device_ring_allgather(v[0], ring)

    assert torch.equal(per_device(ag, xs), tref.allgather_stacked_ref(xs[:, 0]))


def test_a_rank_that_raises_ends_the_call():
    def fn(v, ring):
        if ring.rank == 2:
            raise ValueError("rank 2 failed")
        return ring_ops.device_ring_allgather(v, ring)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 failed"):
        per_device(fn, torch.zeros(4, 3))
    assert time.monotonic() - t0 < TIMEOUT / 2  # not by the timeout


def test_a_rank_that_never_arrives_ends_the_call_within_the_timeout():
    release = threading.Event()

    def fn(v, ring):
        if ring.rank == 1:
            release.wait(60)  # never reaches the collective in time
            return v
        return ring_ops.device_ring_allgather(v, ring)[0]

    t0 = time.monotonic()
    try:
        with pytest.raises(tc.KampingError, match="within 0.5 s"):
            per_device(fn, torch.zeros(4, 3), timeout=0.5)
        assert time.monotonic() - t0 < 10
    finally:
        release.set()


def test_ranks_that_disagree_on_the_shape_raise():
    def fn(v, ring):
        return ring_ops.device_ring_allgather(v[: ring.rank + 1], ring)

    with pytest.raises(RuntimeError):
        per_device(fn, torch.zeros(3, 4))
