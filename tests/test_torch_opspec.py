"""The port's op-spec engine: the table, out-fields, capacity policies, the
leveled assertions, the zero-overhead count paths and the ``i*`` variants.

Counterpart of ``tests/test_opspec.py``, ``tests/test_params.py`` and
``tests/test_nonblocking.py``.  Where a behaviour has a value (a resized
or poisoned buffer, an inferred count), the port runs under
``repro_torch.core.spmd`` and the JAX package under ``jax.vmap`` on the
same NumPy inputs, and the two must agree bit for bit (NaN poisoning
included).  "Nothing launched" is checked by counting the transport
primitives a call reaches.
"""
import operator

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core import transports as tt  # noqa: E402
from repro_torch.core.params import ParamKind, collect_params  # noqa: E402

PS = (1, 2, 4, 8)
CORE_OPS = {
    "allgather", "allgatherv", "gather", "gatherv", "alltoall", "alltoallv",
    "allreduce", "reduce", "reduce_scatter", "scan", "exscan", "bcast",
    "scatter", "scatterv", "barrier", "send_recv",
}


def both(body, *arrs):
    """body(lib, *rank_args) under jax.vmap and under spmd -> numpy pair."""
    j = jax.vmap(lambda *a: body(jc, *a), axis_name="x")(*arrs)
    t = tc.spmd(lambda *a: body(tc, *a),
                *[torch.as_tensor(a) for a in arrs], axis_name="x")
    if isinstance(t, tuple):
        return tuple(np.asarray(v) for v in j), tuple(v.numpy() for v in t)
    return np.asarray(j), t.numpy()


def assert_same(j, t):
    for a, b in zip(j if isinstance(j, tuple) else (j,),
                    t if isinstance(t, tuple) else (t,)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


class level:
    """Assertion level for a block (both packages)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = (jc.set_assertion_level(self.name),
                     tc.set_assertion_level(self.name))

    def __exit__(self, *exc):
        jc.set_assertion_level(self.prev[0])
        tc.set_assertion_level(self.prev[1])


@pytest.fixture
def calls(monkeypatch):
    """Count every transport primitive a call reaches, by name."""
    seen = {}

    def spy(cls, name):
        orig = getattr(cls, name)

        def wrapped(self, comm, x, *a, **kw):
            seen.setdefault(name, []).append(tuple(torch.as_tensor(x).shape))
            return orig(self, comm, x, *a, **kw)

        monkeypatch.setattr(cls, name, wrapped)

    for cls in (tt.NativeTransport, tt.RingTransport):
        for name in ("all_gather", "all_to_all", "reduce_scatter_sum",
                     "allreduce_sum"):
            spy(cls, name)
    return seen


# -- the table ---------------------------------------------------------------
def test_every_core_collective_is_a_table_row():
    assert CORE_OPS == set(tc.OP_TABLE)
    assert set(jc.OP_TABLE) >= CORE_OPS


@pytest.mark.parametrize("name", sorted(CORE_OPS))
def test_core_methods_generated_from_table(name):
    method = getattr(tc.Communicator, name)
    assert method.__name__ == name and method.__doc__
    spec, jspec = tc.OP_TABLE[name], jc.OP_TABLE[name]
    assert spec.nonblocking == jspec.nonblocking
    assert spec.bucketed == jspec.bucketed
    assert spec.heavy_count_check == jspec.heavy_count_check
    assert {k.value for k in spec.accepted} == {k.value
                                                for k in jspec.accepted}
    if spec.nonblocking:
        assert "auto-generated" in getattr(tc.Communicator,
                                           "i" + name).__doc__
    else:
        assert not hasattr(tc.Communicator, "i" + name)


# -- diagnostics before launch ------------------------------------------------
def run1(f, *arrs):
    return tc.spmd(f, *[torch.as_tensor(a) for a in arrs], axis_name="x")


def test_engine_diagnostics():
    x = np.zeros((2, 2, 3, 1), np.float32)
    with pytest.raises(tc.UnsupportedParameterError, match="alltoallv"):
        run1(lambda v: tc.Communicator("x").alltoallv(tc.send_buf(v),
                                                      tc.op(max)), x)
    with pytest.raises(tc.KampingError, match="requires\\s+send_counts"):
        run1(lambda v: tc.Communicator("x").alltoallv(
            tc.send_buf(v), tc.recv_counts_out()), x)
    with pytest.raises(tc.KampingError, match="recv_counts_out\\(\\) "
                       "requires"):
        run1(lambda v: tc.Communicator("x").alltoallv(
            tc.send_buf(v), tc.recv_counts_out(), tc.send_counts_out()), x)
    with pytest.raises(tc.KampingError, match="not inferable"):
        run1(lambda v: tc.Communicator("x").alltoallv(
            tc.send_buf(v), tc.send_counts_out()), x)
    with pytest.raises(tc.KampingError, match="bucketed"):
        run1(lambda v: tc.Communicator("x").alltoallv(tc.send_buf(v[0, 0])),
             x)
    with pytest.raises(tc.KampingError, match="reduce_scatter"):
        run1(lambda v: tc.Communicator("x").reduce_scatter(
            tc.send_buf(v[0, 0]), tc.op(operator.add)), x)
    with pytest.raises(TypeError, match="unexpected keyword"):
        run1(lambda v: tc.Communicator("x").send_recv(tc.send_buf(v),
                                                      prem=[(0, 1)]), x)
    with pytest.raises(TypeError, match="named parameter objects"):
        run1(lambda v: tc.Communicator("x").alltoallv(tc.send_buf(v),
                                                      send_counts=1), x)


def test_gatherv_count_validation():
    x = np.zeros((2, 4, 1), np.float32)
    with pytest.raises(tc.KampingError, match="exceed send_count"):
        run1(lambda v: tc.Communicator("x").gatherv(
            tc.send_buf(v), tc.send_count(2),
            tc.recv_counts(np.array([3, 1]))), x)
    out = run1(lambda v: tc.Communicator("x").gatherv(
        tc.send_buf(v), tc.send_count(2), tc.recv_counts(np.array([2, 1]))),
        x)
    assert tuple(out.shape) == (2, 3, 1)
    with pytest.raises(tc.KampingError, match="traced send_count"):
        run1(lambda v, n: tc.Communicator("x").gatherv(
            tc.send_buf(v), tc.send_count(n),
            tc.recv_counts(np.array([1, 1]))), x,
            np.array([2, 2], np.int32))


# -- out-fields ---------------------------------------------------------------
def test_result_fields_in_request_order():
    x = np.zeros((2, 2, 3, 1), np.float32)
    sc = np.ones((2, 2), np.int32)
    seen = {}

    def probe(order):
        def body(v, c):
            outs = [tc.recv_displs_out(), tc.recv_counts_out()]
            r = tc.Communicator("x").alltoallv(
                tc.send_buf(v), tc.send_counts(c),
                *(outs if order == "displs" else outs[::-1]))
            seen[order] = r.fields()
            return r.recv_buf
        run1(body, x, sc)

    probe("displs")
    probe("counts")
    assert seen["displs"] == ("recv_buf", "recv_displs", "recv_counts")
    assert seen["counts"] == ("recv_buf", "recv_counts", "recv_displs")


@pytest.mark.parametrize("p", PS)
def test_out_fields_match_jax(p):
    x = np.random.RandomState(p).randn(p, p, 3).astype(np.float32)
    sc = np.full((p, p), 2, np.int32)
    j, t = both(lambda L, v, c: tuple(L.Communicator("x").alltoallv(
        L.send_buf(v), L.send_counts(c), L.send_displs_out(),
        L.recv_displs_out(), L.recv_counts_out())), x, sc)
    assert_same(j, t)
    np.testing.assert_array_equal(t[1][0], np.arange(p) * 3)


# -- the zero-overhead count paths ---------------------------------------------
@pytest.mark.parametrize("transport", ["native", "ring"])
def test_alltoallv_static_counts_launch_no_transpose(calls, transport):
    """Static send_counts: recv_counts is a local lookup, so the call
    reaches exactly one alltoall (the buckets).  Per-rank counts add one
    counts transpose."""
    p = 4
    x = torch.arange(p * p * 3, dtype=torch.float32).reshape(p, p, 3)
    static = np.asarray([1, 2, 3, 1], np.int32)

    def body(v):
        r = tc.Communicator("x", transport=transport).alltoallv(
            tc.send_buf(v), tc.send_counts(static), tc.recv_counts_out())
        return r.recv_buf, r.recv_counts

    _, rc = tc.spmd(body, x, axis_name="x")
    assert calls["all_to_all"] == [(p, 3)]
    assert rc.tolist() == [[static[r]] * p for r in range(p)]
    calls.clear()

    def traced(v, c):
        r = tc.Communicator("x", transport=transport).alltoallv(
            tc.send_buf(v), tc.send_counts(c), tc.recv_counts_out())
        return r.recv_counts

    sc = torch.tensor([[(i + j) % 3 for j in range(p)] for i in range(p)],
                      dtype=torch.int32)
    rc = tc.spmd(traced, x, sc, axis_name="x")
    assert calls["all_to_all"] == [(p, 3), (p, 1)]
    assert torch.equal(rc, sc.T)
    calls.clear()
    # without recv_counts_out() nothing beyond the buckets is launched
    tc.spmd(lambda v, c: tc.Communicator("x", transport=transport)
            .alltoallv(tc.send_buf(v), tc.send_counts(c)), x, sc,
            axis_name="x")
    assert calls["all_to_all"] == [(p, 3)]


def test_scatterv_static_counts_launch_no_count_bcast(calls):
    counts = np.asarray([1, 2], np.int32)

    def body(v):
        r = tc.Communicator("x").scatterv(
            tc.send_buf(v), tc.send_counts(counts), tc.recv_count_out(),
            tc.root(0))
        return r.recv_buf, r.recv_count

    _, rc = tc.spmd(body, torch.zeros(2, 2, 3), axis_name="x")
    assert len(calls["allreduce_sum"]) == 1  # the data bcast only
    assert rc.tolist() == [1, 2]


def test_gatherv_ragged_gathers_only_max_count(calls):
    counts = np.asarray([1, 2], np.int64)
    out = tc.spmd(lambda v: tc.Communicator("x").gatherv(
        tc.send_buf(v), tc.recv_counts(counts)), torch.zeros(2, 64, 3),
        axis_name="x")
    assert calls["all_gather"] == [(2, 3)]  # (max(counts), 3), not 64
    assert tuple(out.shape) == (2, 3, 3)


# -- capacity policies and the NORMAL overflow assertion ------------------------
@pytest.mark.parametrize("p", (2, 4))
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("policy", ["resize_to_fit", "grow", "fits",
                                    "overflow"])
def test_alltoallv_capacity_policies(p, dtype, policy):
    """grow_only pads, truncates when the counts fit, and at NORMAL level
    poisons the whole buffer (NaN, or the int's max) when they do not;
    resize_to_fit keeps the send capacity."""
    x = (np.random.RandomState(p).randn(p, p, 3, 2) * 10).astype(dtype)
    sc = np.full((p, p), 3 if policy == "overflow" else 2, np.int32)
    cap_r = {"resize_to_fit": None, "grow": 5, "fits": 2, "overflow": 2}[
        policy]

    def body(L, v, c):
        rb = (L.recv_buf(L.resize_to_fit) if cap_r is None
              else L.recv_buf(L.grow_only(cap_r)))
        return L.Communicator("x", transport="pallas").alltoallv(
            L.send_buf(v), L.send_counts(c), rb)

    j, t = both(body, x, sc)
    assert_same(j, t)
    bad = np.isnan(t) if dtype == np.float32 else t == np.iinfo(dtype).max
    assert bad.all() == (policy == "overflow")
    with level("NONE"):  # no check: the overflowing buckets are truncated
        j, t = both(body, x, sc)
    assert_same(j, t)
    assert not (np.isnan(t).any() if dtype == np.float32
                else (t == np.iinfo(dtype).max).any())


@pytest.mark.parametrize("cap_r,count", [(4, 1), (1, 1), (1, 3)])
def test_scatterv_capacity_policies(cap_r, count):
    p = 4
    rootbuf = np.random.RandomState(0).randn(p, p, 3).astype(np.float32)
    counts = np.full((p, p), count, np.int32)

    def body(L, v, c):
        return L.Communicator("x").scatterv(
            L.send_buf(v), L.send_counts(c), L.root(1),
            L.recv_buf(L.grow_only(cap_r)))

    j, t = both(body, rootbuf, counts)
    assert_same(j, t)
    assert t.shape == (p, cap_r)
    assert np.isnan(t).all() == (count > cap_r)


# -- the HEAVY communication assertion -----------------------------------------
class _Lossy(tt.NativeTransport):
    """A faulty transport for the HEAVY check: its alltoall zeroes the row
    that rank 0 receives."""

    name = "lossy-test"

    def all_to_all(self, comm, x):
        out = super().all_to_all(comm, x)
        return torch.where(comm.rank() == 0, torch.zeros_like(out), out)


tt.register_transport(_Lossy())


@pytest.mark.parametrize("transport", ["native", "ring", "lossy-test"])
def test_heavy_checks_global_sent_equals_received(calls, transport):
    p = 4
    x = torch.ones(p, p, 2, 1)
    sc = torch.full((p, p), 2, dtype=torch.int32)

    def body(v, c):
        return tc.Communicator("x", transport=transport).alltoallv(
            tc.send_buf(v), tc.send_counts(c))

    with level("HEAVY"):
        out = tc.spmd(body, x, sc, axis_name="x")
    # the check costs one counts transpose and two sum allreduces
    assert calls["all_to_all"] == [(p, 2, 1), (p, 1)]
    assert len(calls["allreduce_sum"]) == 2
    assert torch.isnan(out).all() == (transport == "lossy-test")
    calls.clear()
    with level("NORMAL"):
        out = tc.spmd(body, x, sc, axis_name="x")
    assert calls["all_to_all"] == [(p, 2, 1)]
    assert not torch.isnan(out).any()


# -- non-blocking i* variants ----------------------------------------------------
def test_istar_double_completion_over_ring_transport():
    seen = {}

    def f(v):
        comm = tc.Communicator("x", transport="ring")
        req = comm.iallreduce(tc.send_buf(v), tc.op(operator.add))
        assert isinstance(req, tc.NonBlockingResult)
        assert req.op_name == "allreduce"
        out = req.wait()
        with pytest.raises(tc.PendingRequestError) as ei:
            req.wait()
        seen["wait_msg"] = str(ei.value)
        req2 = comm.iallgather(tc.send_buf(v), tc.transport("ring"))
        req2.wait()
        with pytest.raises(tc.PendingRequestError) as ei2:
            req2.test()
        seen["test_msg"] = str(ei2.value)
        return out

    out = tc.spmd(f, torch.arange(8.0).reshape(2, 4), axis_name="x")
    assert torch.equal(out[0], torch.tensor([4.0, 6.0, 8.0, 10.0]))
    assert "moved" not in seen["wait_msg"]
    assert "iallreduce" in seen["wait_msg"]
    assert "iallgather" in seen["test_msg"]


def test_istar_returns_moved_buffers():
    def f(v):
        req = tc.Communicator("x").ibcast(tc.send_recv_buf(tc.move(v)),
                                          tc.root(1))
        out, orig = req.wait()
        return out, orig

    x = torch.arange(6.0).reshape(2, 3)
    out, orig = tc.spmd(f, x, axis_name="x")
    assert torch.equal(out, x[1].expand(2, 3)) and torch.equal(orig, x)


# -- named parameters (test_params.py) ------------------------------------------
def test_collect_params_semantics():
    with pytest.raises(tc.MissingParameterError, match="allgatherv"):
        collect_params("allgatherv", [], required=(ParamKind.SEND_BUF,))
    with pytest.raises(tc.ParameterConflictError):
        collect_params("x", [tc.send_buf([1]), tc.send_buf([2])],
                       required=(ParamKind.SEND_BUF,))
    with pytest.raises(tc.UnsupportedParameterError, match="op"):
        collect_params("bcast", [tc.send_buf([1]), tc.op(max)],
                       required=(ParamKind.SEND_BUF,))
    pack = collect_params(
        "allreduce", [tc.send_recv_buf([1]), tc.op(max)],
        required=((ParamKind.SEND_BUF, ParamKind.SEND_RECV_BUF),
                  ParamKind.OP))
    assert ParamKind.SEND_RECV_BUF in pack
    with pytest.raises(tc.ParameterConflictError):
        collect_params(
            "allgather", [tc.send_recv_buf([1]), tc.send_counts([1])],
            required=((ParamKind.SEND_BUF, ParamKind.SEND_RECV_BUF),),
            accepted=(ParamKind.SEND_COUNTS,),
            in_place_ignored=(ParamKind.SEND_COUNTS,))
    m = tc.move([1, 2, 3])
    p = tc.send_buf(m)
    assert p.moved and p.value == [1, 2, 3]
    with pytest.raises(tc.MovedBufferError):
        m.take()
    assert tc.resize_to_fit.kind == "resize_to_fit"
    assert tc.no_resize.kind == "no_resize"
    assert tc.grow_only(128).capacity == 128
    assert tc.recv_counts_out().is_out and tc.recv_count_out().is_out
