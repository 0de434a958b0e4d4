"""Per-device ranks (``repro_torch.core.shard_map``): every row of the
port's op-spec table and its ``i*`` variants, on ``native`` and ``ring``,
against the emulated ranks (``repro_torch.core.spmd``), bit for bit.

The counterpart of ``tests/md/test_collectives_md.py`` (the JAX package's
rows under a real ``jax.shard_map``) for the rows the port has.  Each case
is one rank program; it runs under ``spmd`` and under ``shard_map`` on the
CPU, at p in {1, 2, 3, 4, 8}, and the results must be equal bit for bit:
every payload is pure data movement (gaussian floats) or sums exactly
(int32, dyadic fp32).  On ``ring`` the per-device mode reaches the plain
versions of B8a/B8b (``kernels/collectives/ref.py``) instead of B1/B2.
"""
import operator
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch.kernels.collectives import ops as ring_ops  # noqa: E402

PS = (1, 2, 3, 4, 8)
TIMEOUT = 30.0  # every rendezvous of these small cases takes milliseconds


def gauss(p, shape, seed=0):
    return np.random.RandomState(seed + p).randn(p, *shape).astype(np.float32)


def dyadic(p, shape, seed=0):
    """fp32 multiples of 1/16 with |x| <= 32: every partial sum of up to 8
    is exact, so any summation order gives the same bits."""
    rng = np.random.RandomState(seed + p)
    return (rng.randint(-512, 513, size=(p,) + shape) / 16.0).astype(
        np.float32)


def ints(p, shape, seed=0):
    return np.random.RandomState(seed + p).randint(
        -50, 50, size=(p,) + shape).astype(np.int32)


def both_modes(body, *arrs, transport="native", block=None):
    """``body(comm, *rank_args)`` under spmd and under shard_map on the
    CPU; returns (emulated, per-device) as tuples of numpy arrays."""
    def prog(*a):
        c = tc.Communicator("x", transport=transport)
        out = body(c.split_by(block=block) if block else c, *a)
        return out if isinstance(out, tuple) else (out,)

    ts = [torch.as_tensor(a) for a in arrs]
    emulated = tc.spmd(prog, *ts, axis_name="x")
    local = tc.shard_map(prog, *ts, axis_name="x", device="cpu",
                         timeout=TIMEOUT)
    return (tuple(t.numpy() for t in emulated),
            tuple(t.numpy() for t in local))


def assert_modes_bitwise(body, *arrs, transports=("native", "ring"),
                         block=None):
    for transport in transports:
        want, got = both_modes(body, *arrs, transport=transport, block=block)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert w.shape == g.shape and w.dtype == g.dtype, transport
            np.testing.assert_array_equal(g, w, err_msg=transport)


def _counts(p):
    return np.asarray([(r * 2 + 1) % 5 for r in range(p)], np.int64)


def _scatterv(c, v, p, cap_r):
    counts = np.asarray([min(r + 1, 2) for r in range(p)], np.int32)
    args = [tc.send_buf(v), tc.send_counts(counts), tc.recv_count_out(),
            tc.root(0)]
    if cap_r is not None:
        args.append(tc.recv_buf(tc.grow_only(cap_r)))
    return tuple(c.scatterv(*args))


def _istar(c, v, s):
    return (c.ialltoallv(tc.send_buf(v), tc.send_counts(s)).wait(),
            c.ireduce_scatter(tc.send_buf(v), tc.op(operator.add)).wait(),
            c.iallgatherv(tc.send_buf(v)).wait(),
            c.iscan(tc.send_buf(v), tc.op(operator.add)).wait(),
            c.ibcast(tc.send_recv_buf(v)).wait(),
            c.iallreduce(tc.send_buf(v), tc.op(operator.add)).wait())


# name -> (rank program, inputs at p); the rows of test_torch_transports.py
ROWS = {
    "allgather": (lambda c, v: c.allgather(tc.send_buf(v)),
                  lambda p: (gauss(p, (3, 2)),)),
    "allgather_in_place": (lambda c, v: c.allgather(tc.send_recv_buf(v)),
                           lambda p: (gauss(p, (p, 2), seed=1),)),
    "allgatherv_static": (
        lambda c, v: tuple(c.allgatherv(
            tc.send_buf(v), tc.send_count(3), tc.recv_counts_out(),
            tc.recv_displs_out())),
        lambda p: (gauss(p, (4, 2), seed=2),)),
    "allgatherv_dynamic": (
        lambda c, v, n: tuple(c.allgatherv(
            tc.send_buf(v), tc.send_count(n), tc.recv_counts_out(),
            tc.recv_displs_out())),
        lambda p: (ints(p, (4, 1), seed=3),
                   (np.arange(p) % 4 + 1).astype(np.int32))),
    "gatherv": (
        lambda c, v: tuple(c.gatherv(
            tc.send_buf(v), tc.recv_counts(_counts(c.size())),
            tc.recv_displs_out(), tc.root(0))),
        lambda p: (gauss(p, (4, 2), seed=2),)),
    "gather": (lambda c, v: c.gather(tc.send_buf(v), tc.root(c.size() - 1)),
               lambda p: (gauss(p, (2, 3), seed=4),)),
    "alltoall": (lambda c, v: c.alltoall(tc.send_buf(v)),
                 lambda p: (gauss(p, (p, 2, 2), seed=5),)),
    "alltoallv_inferred": (
        lambda c, v, s: tuple(c.alltoallv(
            tc.send_buf(v), tc.send_counts(s), tc.recv_counts_out(),
            tc.recv_displs_out(), tc.send_displs_out())),
        lambda p: (ints(p, (p, 3, 2), seed=6),
                   np.asarray([[(i + j) % 4 for j in range(p)]
                               for i in range(p)], np.int32))),
    "alltoallv_capacity": (
        lambda c, v, s: c.alltoallv(tc.send_buf(v), tc.send_counts(s),
                                    tc.recv_buf(tc.grow_only(5))),
        lambda p: (gauss(p, (p, 3, 2), seed=7), np.full((p, p), 2, np.int32))),
    "allreduce_add_max_min": (
        lambda c, v: tuple(c.allreduce(tc.send_buf(v), tc.op(fn))
                           for fn in (operator.add, max, min)),
        lambda p: (ints(p, (3, 5), seed=8),)),
    "allreduce_dyadic": (
        lambda c, v: c.allreduce(tc.send_buf(v), tc.op(operator.add)),
        lambda p: (dyadic(p, (3, 5), seed=8),)),
    "reduce": (
        lambda c, v: tuple(c.reduce(tc.send_buf(v), tc.op(fn), tc.root(0))
                           for fn in (operator.add, max)),
        lambda p: (dyadic(p, (3, 5), seed=8),)),
    "allreduce_logical_and_lambda": (
        lambda c, f, v: (c.allreduce(tc.send_buf(f), tc.op("and")),
                         c.allreduce(tc.send_buf(f), tc.op("or")),
                         c.allreduce(tc.send_buf(v),
                                     tc.op(lambda a, b: a - 0.5 * b))),
        lambda p: ((ints(p, (4,), seed=9) > 0).astype(np.int32),
                   gauss(p, (3,), seed=10))),
    "reduce_scatter": (
        lambda c, v: (c.reduce_scatter(tc.send_buf(v), tc.op(operator.add)),
                      c.reduce_scatter(tc.send_buf(v), tc.op(max))),
        lambda p: (ints(p, (p, 2, 2), seed=11),)),
    "reduce_scatter_dyadic": (
        lambda c, v: c.reduce_scatter(tc.send_buf(v), tc.op(operator.add)),
        lambda p: (dyadic(p, (p, 2, 2), seed=11),)),
    "scan_exscan": (
        lambda c, v: (c.scan(tc.send_buf(v), tc.op(operator.add)),
                      c.exscan(tc.send_buf(v), tc.op(operator.add)),
                      c.scan(tc.send_buf(v), tc.op(lambda a, b: a * 2 - b)),
                      c.exscan(tc.send_buf(v),
                               tc.op(lambda a, b: a * 2 - b))),
        lambda p: (dyadic(p, (3,), seed=12),)),
    "bcast": (
        lambda c, v: (c.bcast(tc.send_recv_buf(v), tc.root(0)),
                      c.bcast(tc.send_recv_buf(v), tc.root(c.size() - 1))),
        lambda p: (gauss(p, (2, 3), seed=13),)),
    "scatter": (lambda c, v: c.scatter(tc.send_buf(v), tc.root(0)),
                lambda p: (gauss(p, (p, 3), seed=14),)),
    "scatterv": (
        lambda c, v: tuple(
            t for cap_r in (None, 2, 4)
            for t in _scatterv(c, v, c.size(), cap_r)),
        lambda p: (gauss(p, (p, 3, 2), seed=15),)),
    "send_recv_and_barrier": (
        lambda c, v: (
            c.send_recv(tc.send_buf(v), perm=[(i, (i + 1) % c.size())
                                              for i in range(c.size())]),
            c.send_recv(tc.send_buf(v), tc.dest(lambda r: r + 2)),
            c.barrier()),
        lambda p: (gauss(p, (3,), seed=16),)),
    "istar_variants": (_istar, lambda p: (dyadic(p, (p, 2), seed=19),
                                          np.full((p, p), 2, np.int32))),
    "host_values": (
        lambda c, v: (c.allreduce(tc.send_buf(3), tc.op(operator.add)),
                      c.allgather(tc.send_buf(np.arange(2, dtype=np.int32)))),
        lambda p: (np.zeros((p, 1), np.float32),)),
}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("row", sorted(ROWS))
def test_row_per_device_equals_emulated(row, p):
    body, inputs = ROWS[row]
    assert_modes_bitwise(body, *inputs(p))


@pytest.mark.parametrize("p", (2, 4, 8))
def test_rows_on_split_communicators(p):
    """Split communicators run per device on native; on ring they raise,
    as the JAX package's per-device kernels refuse process groups."""
    for block in sorted({max(1, p // 2), p}):
        xb = dyadic(p, (block, 2), seed=18)
        body = lambda c, v, block=block: (  # noqa: E731
            c.allgather(tc.send_buf(v)),
            c.alltoall(tc.send_buf(v)),
            c.reduce_scatter(tc.send_buf(v), tc.op(operator.add)),
            c.allreduce(tc.send_buf(v), tc.op(operator.add)),
            c.allreduce(tc.send_buf(v), tc.op(max)),
            c.scan(tc.send_buf(v), tc.op(operator.add)),
            c.bcast(tc.send_recv_buf(v), tc.root(block - 1)),
            c.send_recv(tc.send_buf(v),
                        perm=[(i, (i + 1) % block) for i in range(block)]))
        assert_modes_bitwise(body, xb, transports=("native",), block=block)
    with pytest.raises(tc.KampingError, match="process groups"):
        tc.shard_map(lambda v: tc.Communicator("x", transport="ring")
                     .split_by(block=p // 2).allgather(tc.send_buf(v)),
                     torch.zeros(p, 2), device="cpu", timeout=TIMEOUT)


def test_nonblocking_inside_shard_map():
    """tests/md/test_collectives_md.py::test_nonblocking_inside_shard_map:
    the value is hidden until wait(); the moved buffer comes back."""
    def f(x):
        comm = tc.Communicator("x")
        req = comm.iallreduce(tc.send_buf(tc.move(x)), tc.op(operator.add))
        with pytest.raises(tc.PendingRequestError):
            _ = req.value
        val, orig = req.wait()
        return val + 0 * orig

    x = torch.arange(8, dtype=torch.float32).reshape(8, 1)
    out = tc.shard_map(f, x, device="cpu", timeout=TIMEOUT)
    assert out.shape == (8, 1) and bool((out == 28).all())


def test_rank_and_size_are_per_device():
    def f(x):
        c = tc.Communicator("x")
        assert c.rank().dim() == 0 and c.rank().dtype == torch.int64
        return torch.stack([c.rank(), torch.tensor(c.size())]) + 0 * x[:1]

    out = tc.shard_map(f, torch.zeros(4, 1, dtype=torch.int64),
                       device="cpu", timeout=TIMEOUT)
    np.testing.assert_array_equal(out.numpy(),
                                  [[r, 4] for r in range(4)])


def test_ring_uses_the_device_ring_and_no_stacked_kernel(monkeypatch):
    """On ring, per-device ranks reach B8a/B8b (here their plain versions)
    once per rank per call, and never the stacked B1/B2/B4 wrappers."""
    seen = []
    lock = threading.Lock()
    for name in ("device_ring_allgather", "device_ring_reduce_scatter"):
        orig = getattr(ring_ops, name)

        def spy(x, ring, *, force_ref=False, orig=orig, name=name):
            with lock:
                seen.append(name)
            return orig(x, ring, force_ref=force_ref)

        monkeypatch.setattr(ring_ops, name, spy)
    for name in ("ring_allgather", "ring_reduce_scatter", "ring_alltoall"):
        monkeypatch.setattr(ring_ops, name, lambda *a, **k: pytest.fail(
            "stacked ring kernel on per-device ranks"))
    x = dyadic(4, (10,), seed=21)
    out = tc.shard_map(lambda v: tc.Communicator("x", transport="ring")
                       .allreduce(tc.send_buf(v), tc.op(operator.add)),
                       torch.as_tensor(x), device="cpu", timeout=TIMEOUT)
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(
        x.sum(0), (4, 10)))
    assert sorted(seen) == ["device_ring_allgather"] * 4 + [
        "device_ring_reduce_scatter"] * 4


@pytest.mark.parametrize("transport", ["native", "ring"])
def test_gradient_on_per_device_ranks_raises(transport):
    def loss(v):
        c = tc.Communicator("x", transport=transport)
        return c.allreduce(tc.send_buf(v), tc.op(operator.add)).sum()

    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        tc.shard_map(lambda v: torch.autograd.grad(
            loss(v.requires_grad_()), v)[0], torch.ones(2, 3), device="cpu",
            timeout=TIMEOUT)


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tc.KampingError, match="device='cpu'"):
        tc.shard_map(lambda v: v, torch.zeros(2, 1))


def test_arguments_need_one_leading_rank_dimension():
    with pytest.raises(tc.KampingError, match="same leading rank"):
        tc.shard_map(lambda a, b: a, torch.zeros(2, 1), torch.zeros(3, 1),
                     device="cpu")
