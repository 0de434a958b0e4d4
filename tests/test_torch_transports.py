"""Every row of the port's op-spec table on both transports, against the
JAX package and the NumPy oracle.

Counterpart of ``tests/test_transports_equivalence.py`` (and of the row
coverage of ``tests/test_oracle_differential.py``).  Each case is one rank
program written once against either package's public names; it runs

* in the JAX package under ``jax.vmap(axis_name="x")`` on ``xla`` and on
  ``pallas`` (whose CPU path is the ppermute ring references), and
* in the port under ``repro_torch.core.spmd`` on ``native`` and on
  ``ring`` (whose CPU path is the ring kernels' plain versions),

at p ∈ {1, 2, 4, 8}, flat and on ``split_by(block=)``.  The four results
must agree bit for bit — every payload is either pure data movement
(gaussian floats) or sums exactly (int32, dyadic fp32) — and agree with
``tests/reference_mpi.py`` where the oracle has the row.
"""
import operator

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import reference_mpi as ref  # noqa: E402
import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402

PS = (1, 2, 4, 8)


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


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_np(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def run_all(body, *arrs, block=None):
    """``body(lib, transport, *rank_args)`` on JAX xla/pallas and on the
    port's native/ring; returns {(package, transport): numpy result}."""
    def comm(lib, t):
        c = lib.Communicator("x", transport=t)
        return c.split_by(block=block) if block else c

    outs = {}
    for t in ("xla", "pallas"):
        outs["jax", t] = _np(jax.vmap(
            lambda *a, t=t: body(jc, comm(jc, t), *a), axis_name="x")(*arrs))
    for t in ("native", "ring"):
        outs["torch", t] = _np(tc.spmd(
            lambda *a, t=t: body(tc, comm(tc, t), *a),
            *[torch.as_tensor(a) for a in arrs], axis_name="x"))
    return outs


def assert_all_bitwise(outs):
    want = outs["jax", "xla"]
    for key, got in outs.items():
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape, key
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=str(key))
    return outs["torch", "ring"]


def assert_oracle(got, per_rank):
    for r, want in enumerate(per_rank):
        np.testing.assert_array_equal(got[r], np.asarray(want))


def _blocks(p):
    return sorted({max(1, p // 2), p})


# -- gathers ----------------------------------------------------------------
@pytest.mark.parametrize("p", PS)
def test_allgather_and_in_place(p):
    x = gauss(p, (3, 2))
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.allgather(L.send_buf(v)), x))
    assert_oracle(got, ref.allgather(x))
    bufs = gauss(p, (p, 2), seed=1)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.allgather(L.send_recv_buf(v)), bufs))
    assert_oracle(got, ref.allgather_inplace(bufs))


@pytest.mark.parametrize("p", PS)
def test_allgatherv_three_count_regimes(p):
    x = gauss(p, (4, 2), seed=2)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: tuple(c.allgatherv(
            L.send_buf(v), L.send_count(3), L.recv_counts_out(),
            L.recv_displs_out())), x))
    assert_oracle(got[0], ref.allgatherv_exact(x, 3))

    xi = ints(p, (4, 1), seed=3)
    ns = (np.arange(p) % 4 + 1).astype(np.int32)
    got = assert_all_bitwise(run_all(
        lambda L, c, v, n: tuple(c.allgatherv(
            L.send_buf(v), L.send_count(n), L.recv_counts_out(),
            L.recv_displs_out())), xi, ns))
    want_buf, want_rc, want_rd = ref.allgatherv_padded(xi, ns)
    assert_oracle(got[0], want_buf)
    assert_oracle(got[1], [want_rc] * p)
    assert_oracle(got[2], [want_rd] * p)

    counts = np.asarray([(r * 2 + 1) % 5 for r in range(p)], np.int64)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: tuple(c.gatherv(
            L.send_buf(v), L.recv_counts(counts), L.recv_displs_out(),
            L.root(0))), x))
    want_buf, _, want_rd = ref.allgatherv_ragged(x, counts)
    assert_oracle(got[0], want_buf)
    assert_oracle(got[1], [want_rd] * p)


@pytest.mark.parametrize("p", PS)
def test_gather(p):
    x = gauss(p, (2, 3), seed=4)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.gather(L.send_buf(v), L.root(p - 1)), x))
    assert_oracle(got, ref.allgather(x))


# -- all-to-alls ------------------------------------------------------------
@pytest.mark.parametrize("p", PS)
def test_alltoall(p):
    x = gauss(p, (p, 2, 2), seed=5)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.alltoall(L.send_buf(v)), x))
    assert_oracle(got, ref.alltoall(x))


@pytest.mark.parametrize("p", PS)
def test_alltoallv_inferred_counts(p):
    x = ints(p, (p, 3, 2), seed=6)
    sc = np.asarray([[(i + j) % 4 for j in range(p)] for i in range(p)],
                    np.int32)
    got = assert_all_bitwise(run_all(
        lambda L, c, v, s: tuple(c.alltoallv(
            L.send_buf(v), L.send_counts(s), L.recv_counts_out(),
            L.recv_displs_out(), L.send_displs_out())), x, sc))
    assert_oracle(got[0], ref.alltoall(x))
    assert_oracle(got[1], ref.counts_transpose(sc))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("cap_r", [2, 5])
def test_alltoallv_capacity_policy(p, cap_r):
    x = gauss(p, (p, 3, 2), seed=7)
    sc = np.full((p, p), 2, np.int32)  # counts fit cap_r=2: no poisoning
    got = assert_all_bitwise(run_all(
        lambda L, c, v, s: c.alltoallv(
            L.send_buf(v), L.send_counts(s), L.recv_buf(L.grow_only(cap_r))),
        x, sc))
    assert got.shape == (p, p, cap_r, 2)
    assert_oracle(got, ref.alltoallv(x, cap_r=cap_r))


# -- reductions -------------------------------------------------------------
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("payload", ["int32", "dyadic"])
def test_allreduce_and_reduce(p, payload):
    x = (ints if payload == "int32" else dyadic)(p, (3, 5), seed=8)
    for name, fn, fold in (("add", operator.add, np.add),
                           ("max", max, np.maximum),
                           ("min", min, np.minimum)):
        got = assert_all_bitwise(run_all(
            lambda L, c, v: c.allreduce(L.send_buf(v), L.op(fn)), x))
        assert_oracle(got, ref.allreduce(x, fold))
        got = assert_all_bitwise(run_all(
            lambda L, c, v: c.reduce(L.send_buf(v), L.op(fn), L.root(0)),
            x))
        assert_oracle(got, ref.allreduce(x, fold))


@pytest.mark.parametrize("p", PS)
def test_allreduce_logical_and_lambda(p):
    flags = (ints(p, (4,), seed=9) > 0).astype(np.int32)
    for name, fold in (("and", np.minimum), ("or", np.maximum)):
        got = assert_all_bitwise(run_all(
            lambda L, c, v: c.allreduce(L.send_buf(v), L.op(name)), flags))
        assert_oracle(got, ref.allreduce(flags, fold))
    x = gauss(p, (3,), seed=10)
    fn = lambda a, b: a - 0.5 * b  # noqa: E731 - non-commutative on purpose
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.allreduce(L.send_buf(v), L.op(fn)), x))
    assert_oracle(got, ref.allreduce(x, fn))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("payload", ["int32", "dyadic"])
def test_reduce_scatter(p, payload):
    x = (ints if payload == "int32" else dyadic)(p, (p, 2, 2), seed=11)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.reduce_scatter(L.send_buf(v), L.op(operator.add)),
        x))
    assert_oracle(got, ref.reduce_scatter(x, np.add))
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.reduce_scatter(L.send_buf(v), L.op(max)), x))
    assert_oracle(got, ref.reduce_scatter(x, np.maximum))


@pytest.mark.parametrize("p", PS)
def test_scan_exscan(p):
    x = dyadic(p, (3,), seed=12)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: (c.scan(L.send_buf(v), L.op(operator.add)),
                         c.exscan(L.send_buf(v), L.op(operator.add))), x))
    assert_oracle(got[0], ref.scan(x, np.add))
    assert_oracle(got[1], ref.exscan(x, np.add))
    fn = lambda a, b: a * 2 - b  # noqa: E731
    got = assert_all_bitwise(run_all(
        lambda L, c, v: (c.scan(L.send_buf(v), L.op(fn)),
                         c.exscan(L.send_buf(v), L.op(fn))), x))
    assert_oracle(got[0], ref.scan(x, fn))
    assert_oracle(got[1], ref.exscan(x, fn))


# -- rooted ops -------------------------------------------------------------
@pytest.mark.parametrize("p", PS)
def test_bcast_scatter_scatterv(p):
    x = gauss(p, (2, 3), seed=13)
    for r in sorted({0, p - 1}):
        got = assert_all_bitwise(run_all(
            lambda L, c, v: c.bcast(L.send_recv_buf(v), L.root(r)), x))
        assert_oracle(got, ref.bcast(x, r))
    bufs = gauss(p, (p, 3), seed=14)
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.scatter(L.send_buf(v), L.root(0)), bufs))
    assert_oracle(got, ref.scatter(bufs, 0))
    counts = np.asarray([min(r + 1, 2) for r in range(p)], np.int32)
    rootbuf = gauss(p, (p, 3, 2), seed=15)
    for cap_r in (None, 2, 4):
        extra = () if cap_r is None else (cap_r,)

        def body(L, c, v, cap_r=cap_r):
            args = [L.send_buf(v), L.send_counts(counts), L.recv_count_out(),
                    L.root(0)]
            if cap_r is not None:
                args.append(L.recv_buf(L.grow_only(cap_r)))
            return tuple(c.scatterv(*args))

        got = assert_all_bitwise(run_all(body, rootbuf))
        want, want_counts = ref.scatterv(rootbuf, counts, 0, *extra)
        assert_oracle(got[0], want)
        assert_oracle(got[1], want_counts)


# -- point-to-point and barrier ---------------------------------------------
@pytest.mark.parametrize("p", PS)
def test_send_recv_and_barrier(p):
    x = gauss(p, (3,), seed=16)
    perm = [(i, (i + 1) % p) for i in range(p)]
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.send_recv(L.send_buf(v), perm=perm), x))
    assert_oracle(got, ref.send_recv(x, perm))
    got = assert_all_bitwise(run_all(
        lambda L, c, v: c.send_recv(L.send_buf(v),
                                    L.dest(lambda r: r + 2)), x))
    assert_oracle(got, ref.send_recv(x, [(i, (i + 2) % p)
                                         for i in range(p)]))
    got = assert_all_bitwise(run_all(lambda L, c, v: c.barrier(), x))
    assert (got == 0).all()


# -- process groups (split_by(block=)) and the i* variants ------------------
@pytest.mark.parametrize("p", PS)
def test_rows_on_split_communicators(p):
    for block in _blocks(p):
        xb = dyadic(p, (block, 2), seed=18)
        assert_all_bitwise(run_all(
            lambda L, c, v: (
                c.allgather(L.send_buf(v)),
                c.alltoall(L.send_buf(v)),
                c.reduce_scatter(L.send_buf(v), L.op(operator.add)),
                c.allreduce(L.send_buf(v), L.op(operator.add)),
                c.allreduce(L.send_buf(v), L.op(max)),
                c.scan(L.send_buf(v), L.op(operator.add)),
                c.bcast(L.send_recv_buf(v), L.root(block - 1)),
                c.send_recv(L.send_buf(v),
                            perm=[(i, (i + 1) % block)
                                  for i in range(block)]),
            ), xb, block=block))


@pytest.mark.parametrize("p", PS)
def test_istar_variants_match_blocking(p):
    x = dyadic(p, (p, 2), seed=19)
    sc = np.full((p, p), 2, np.int32)

    def body(L, c, v, s):
        return (c.ialltoallv(L.send_buf(v), L.send_counts(s)).wait(),
                c.ireduce_scatter(L.send_buf(v), L.op(operator.add)).wait(),
                c.iallgatherv(L.send_buf(v)).wait(),
                c.iscan(L.send_buf(v), L.op(operator.add)).wait(),
                c.ibcast(L.send_recv_buf(v)).wait())

    def blocking(L, c, v, s):
        return (c.alltoallv(L.send_buf(v), L.send_counts(s)),
                c.reduce_scatter(L.send_buf(v), L.op(operator.add)),
                c.allgatherv(L.send_buf(v)),
                c.scan(L.send_buf(v), L.op(operator.add)),
                c.bcast(L.send_recv_buf(v)))

    got = assert_all_bitwise(run_all(body, x, sc))
    want = assert_all_bitwise(run_all(blocking, x, sc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("p", PS)
def test_unbatched_value_reaches_the_collective(p):
    """A value that is the same on every rank reaches the collective
    unbatched; both transports expand it (the ring kernels through a
    contiguous copy) and agree with the JAX package."""
    w = dyadic(1, (5,), seed=20)[0]
    got = assert_all_bitwise(run_all(
        lambda L, c, v: (c.allreduce(L.send_buf(L_const(L, w, v)),
                                     L.op(operator.add)),
                         c.allgather(L.send_buf(L_const(L, w, v)))),
        np.zeros((p,), np.float32)))
    np.testing.assert_array_equal(got[0], np.broadcast_to(w * p, (p, 5)))


def L_const(L, w, v):
    """``w`` as a constant of the rank program's package (not batched)."""
    if L is tc:
        return torch.as_tensor(w)
    return jax.numpy.asarray(w)


def test_ring_on_unsupported_layouts_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        tc.spmd(lambda v: tc.Communicator("x", transport="ring")
                .split_by(stride=2).allgather(tc.send_buf(v)),
                torch.zeros(4, 1), axis_name="x")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        def loss(v):
            c = tc.Communicator("x", transport="ring")
            return c.allreduce(tc.send_buf(v), tc.op(operator.add)).sum()

        tc.spmd(torch.func.grad(loss), torch.ones(2, 3), axis_name="x")


def test_spmd_arguments_share_one_device():
    with pytest.raises(tc.KampingError, match="device of the first"):
        tc.spmd(lambda a, b: a + b, torch.zeros(2, 3),
                torch.zeros(2, 3, device="meta"), axis_name="x")


@pytest.mark.parametrize("transport", ["native", "ring"])
@pytest.mark.parametrize("row", ["allreduce", "allgather", "alltoall",
                                 "bcast", "reduce_scatter"])
def test_tensor_on_another_device_raises(transport, row):
    """A payload on another device than the ranks' is refused, never copied
    over: the collective's work stays on the device the ranks run on."""
    far = torch.zeros(2, 3, device="meta")
    calls = {
        "allreduce": lambda c: c.allreduce(tc.send_buf(far),
                                           tc.op(operator.add)),
        "allgather": lambda c: c.allgather(tc.send_buf(far)),
        "alltoall": lambda c: c.alltoall(tc.send_buf(far)),
        "bcast": lambda c: c.bcast(tc.send_recv_buf(far)),
        "reduce_scatter": lambda c: c.reduce_scatter(tc.send_buf(far),
                                                     tc.op(operator.add)),
    }
    with pytest.raises(tc.KampingError, match="tensor on meta"):
        tc.spmd(lambda v: calls[row](tc.Communicator("x",
                                                     transport=transport)),
                torch.zeros(2, 1), axis_name="x")


@pytest.mark.parametrize("transport", ["native", "ring"])
def test_host_values_move_to_the_ranks_device(transport):
    """Python scalars and NumPy arrays are not tensors yet: they are put on
    the ranks' device."""
    def body(v):
        c = tc.Communicator("x", transport=transport)
        return (c.allreduce(tc.send_buf(3), tc.op(operator.add)),
                c.allgather(tc.send_buf(np.arange(2, dtype=np.int32))))

    total, gathered = tc.spmd(body, torch.zeros(4, 1), axis_name="x")
    np.testing.assert_array_equal(total.numpy(), np.full(4, 12))
    np.testing.assert_array_equal(gathered.numpy(),
                                  np.tile(np.arange(2), (4, 4)))
