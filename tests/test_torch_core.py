"""The port's collective layer against the JAX package and the oracle.

``allreduce`` (add, max, min, a non-commutative lambda) and ``allgather``
(plus its in-place form), flat and under ``split_by(block=)``, at
p ∈ {1, 2, 4, 8}.  The port runs each rank program under
``repro_torch.core.spmd``; the JAX package under ``jax.vmap`` with a named
axis; ``tests/reference_mpi.py`` folds in rank order.  On int and dyadic
float payloads all three agree bit for bit.
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
DTYPES = ("int32", "dyadic")


def _data(p, shape, kind, seed=0):
    rng = np.random.RandomState(seed + p)
    ints = rng.randint(-50, 50, size=(p,) + shape)
    if kind == "int32":
        return ints.astype(np.int32)
    return (ints / 8.0).astype(np.float32)  # exact in fp32 sums


def _both(jfn, tfn, x):
    """Run the same rank program through both packages."""
    jout = jax.vmap(jfn, axis_name="x")(x)
    tout = tc.spmd(tfn, torch.as_tensor(x), axis_name="x")
    return np.asarray(jout), tout.numpy()


def _blocks(p):
    return sorted({1, max(1, p // 2), p})


def _group_oracle(x, block, fn):
    out = []
    for r in range(x.shape[0]):
        lo = (r // block) * block
        out.append(fn(list(x[lo:lo + block]))[0])
    return np.stack(out)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("name,jop,top", [
    ("add", operator.add, operator.add),
    ("max", max, max),
    ("min", min, min),
])
def test_allreduce_flat(p, kind, name, jop, top):
    x = _data(p, (3, 2), kind)
    j, t = _both(
        lambda v: jc.Communicator("x").allreduce(jc.send_buf(v), jc.op(jop)),
        lambda v: tc.Communicator("x").allreduce(tc.send_buf(v), tc.op(top)),
        x,
    )
    fold = {"add": np.add, "max": np.maximum, "min": np.minimum}[name]
    np.testing.assert_array_equal(t, np.stack(ref.allreduce(x, fold)))
    np.testing.assert_array_equal(t, j)
    assert t.dtype == x.dtype


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("name,fn", [("add", operator.add), ("max", max)])
def test_allreduce_split_by_block(p, kind, name, fn):
    x = _data(p, (2, 3), kind, seed=1)
    fold = {"add": np.add, "max": np.maximum}[name]
    for block in _blocks(p):
        j, t = _both(
            lambda v: jc.Communicator("x").split_by(block=block).allreduce(
                jc.send_buf(v), jc.op(fn)),
            lambda v: tc.Communicator("x").split_by(block=block).allreduce(
                tc.send_buf(v), tc.op(fn)),
            x,
        )
        want = _group_oracle(x, block, lambda rows: ref.allreduce(rows, fold))
        np.testing.assert_array_equal(t, want)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("p", PS)
def test_allreduce_lambda_folds_in_rank_order(p):
    x = _data(p, (4,), "dyadic", seed=2)
    j, t = _both(
        lambda v: jc.Communicator("x").allreduce(
            jc.send_buf(v), jc.op(lambda a, b: a - 2 * b)),
        lambda v: tc.Communicator("x").allreduce(
            tc.send_buf(v), tc.op(lambda a, b: a - 2 * b)),
        x,
    )
    want = np.stack(ref.allreduce(x, lambda a, b: a - 2 * b))
    np.testing.assert_array_equal(t, want)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", DTYPES)
def test_allgather_flat_and_split(p, kind):
    x = _data(p, (3, 2), kind, seed=3)
    j, t = _both(
        lambda v: jc.Communicator("x").allgather(jc.send_buf(v)),
        lambda v: tc.Communicator("x").allgather(tc.send_buf(v)),
        x,
    )
    np.testing.assert_array_equal(t, np.stack(ref.allgather(x)))
    np.testing.assert_array_equal(t, j)
    for block in _blocks(p):
        j, t = _both(
            lambda v: jc.Communicator("x").split_by(block=block).allgather(
                jc.send_buf(v)),
            lambda v: tc.Communicator("x").split_by(block=block).allgather(
                tc.send_buf(v)),
            x,
        )
        want = _group_oracle(x, block, ref.allgather)
        np.testing.assert_array_equal(t, want)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("p", PS)
def test_allgather_in_place(p):
    bufs = _data(p, (p, 2), "int32", seed=4)
    j, t = _both(
        lambda v: jc.Communicator("x").allgather(jc.send_recv_buf(v)),
        lambda v: tc.Communicator("x").allgather(tc.send_recv_buf(v)),
        bufs,
    )
    np.testing.assert_array_equal(t, np.stack(ref.allgather_inplace(bufs)))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("p", PS)
def test_topology_and_nonblocking(p):
    def body(v):
        c = tc.Communicator("x")
        sub = c.split_by(block=max(1, p // 2))
        assert c.size() == p and sub.size() == max(1, p // 2)
        req = c.iallreduce(tc.send_buf(v), tc.op(operator.add))
        assert isinstance(req, tc.NonBlockingResult)
        return req.wait(), c.rank(), sub.rank()

    x = torch.ones(p, 2, dtype=torch.int32)
    total, rank, sub_rank = tc.spmd(body, x, axis_name="x")
    assert (total == p).all()
    assert rank.tolist() == list(range(p))
    assert sub_rank.tolist() == [r % max(1, p // 2) for r in range(p)]


def test_unknown_parameter_is_a_kamping_error():
    def body(v):
        return tc.Communicator("x").allgather(tc.send_buf(v), tc.op(max))

    with pytest.raises(tc.KampingError, match="not accepted"):
        tc.spmd(body, torch.zeros(2, 1), axis_name="x")
    with pytest.raises(tc.MissingParameterError, match="op"):
        tc.spmd(lambda v: tc.Communicator("x").allreduce(tc.send_buf(v)),
                torch.zeros(2, 1), axis_name="x")
    with pytest.raises(tc.ParameterConflictError):
        tc.spmd(lambda v: tc.Communicator("x").allgather(
            tc.send_buf(v), tc.send_buf(v)), torch.zeros(2, 1), axis_name="x")


def test_unported_features_refuse_with_roadmap_item():
    x = torch.zeros(2, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tc.Communicator(("x", "y"))
    # the ring transport (and its pallas alias) is ported: no refusal
    for name in ("ring", "pallas"):
        out = tc.spmd(lambda v: tc.Communicator("x", transport=name)
                      .allgather(tc.send_buf(v)), x + 1, axis_name="x")
        assert out.shape == (2, 2) and (out == 1).all()
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tc.spmd(lambda v: tc.Communicator("x").allreduce(
            tc.send_buf(v), tc.op(operator.add), tc.compression("int8-ef")),
            x, axis_name="x")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tc.Communicator("x", plan="auto")
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        tc.spmd(lambda v: tc.Communicator("x").split_by(stride=1)
                .allgather(tc.send_buf(v)), x, axis_name="x")
    # the xla alias is the native transport; None-valued hooks are accepted
    out = tc.spmd(lambda v: tc.Communicator("x", transport="xla").allreduce(
        tc.send_buf(v), tc.op(operator.add), tc.compression(None),
        tc.deterministic(None), tc.plan(None)), x + 1, axis_name="x")
    assert (out == 2).all()


def test_axis_must_be_bound_and_innermost():
    with pytest.raises(tc.KampingError, match="unbound axis"):
        tc.Communicator("x").allreduce(tc.send_buf(torch.zeros(1)),
                                       tc.op(operator.add))

    def nested(v):
        return torch.func.vmap(lambda r: tc.Communicator("x").allreduce(
            tc.send_buf(r), tc.op(operator.add)))(v)

    with pytest.raises(tc.KampingError, match="innermost"):
        tc.spmd(nested, torch.zeros(2, 3, 1), axis_name="x")
    with pytest.raises(tc.KampingError, match="positive divisor"):
        tc.spmd(lambda v: tc.Communicator("x").split_by(block=3)
                .allgather(tc.send_buf(v)), torch.zeros(4, 1), axis_name="x")


def test_sum_allreduce_gradient_under_vmap():
    """vmap(grad) through the sum allreduce: d/dx_r sum_q (sum_j x_j)^2 is
    2 * p * sum_j x_j on every rank (what slice 2's trainer relies on)."""
    x = torch.arange(6.0).reshape(3, 2)

    def loss(v):
        s = tc.Communicator("x").allreduce(tc.send_buf(v), tc.op(operator.add))
        return (s ** 2).sum()

    g = tc.spmd(torch.func.grad(loss), x, axis_name="x")
    want = 2 * 3 * x.sum(0)
    assert torch.equal(g, want.expand_as(g))


def test_request_pool_waitall_order():
    pool = tc.RequestPool(slots=2)
    assert pool.submit(tc.NonBlockingResult(1)) is None
    pool.submit(tc.NonBlockingResult(2))
    assert pool.submit(tc.NonBlockingResult(3)) == 1  # backpressure
    assert pool.waitall() == [2, 3] and len(pool) == 0
