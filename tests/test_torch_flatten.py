"""The port's ``flatten.py`` and ``serialization.py`` against the JAX
package.

Counterpart of ``tests/test_flatten.py`` and ``tests/test_serialization.py``:
the same messages and keys, made with NumPy from a seed, go through
``with_flattened`` / ``flatten_buckets`` / ``bucketize_by_destination`` of
both packages (the per-rank bucketization under ``spmd`` and
``jax.vmap``), and must agree bit for bit.  Serialized buffers round-trip
and travel through ``bcast`` and ``send_recv`` on both transports.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402


@given(st.dictionaries(
    st.integers(0, 7),
    st.lists(st.integers(-1000, 1000), min_size=0, max_size=9),
    max_size=8))
def test_flatten_buckets_matches_jax(messages):
    msgs = {k: np.asarray(v, np.int32) for k, v in messages.items()}
    jb, jcnt = jc.flatten_buckets(msgs, 8)
    tb, tcnt = tc.flatten_buckets(msgs, 8)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    assert tb.numpy().dtype == jb.dtype and tcnt.dtype == torch.int32


def test_with_flattened_call_protocol():
    fc = tc.with_flattened({0: [1, 2], 2: [3]}, 4)
    got = fc.call(lambda sb, sc: (tuple(sb.value.shape), sc.value.tolist()))
    assert got == ((4, 2), [2, 0, 1, 0])
    buckets, counts = fc
    assert buckets.tolist() == [[1, 2], [0, 0], [3, 0], [0, 0]]
    with pytest.raises(TypeError, match="dict"):
        tc.with_flattened([1, 2], 4)
    with pytest.raises(ValueError, match="out of range"):
        tc.flatten_buckets({5: [1]}, 4)


@pytest.mark.parametrize("p", (1, 2, 4, 8))
@pytest.mark.parametrize("cap", (2, 8))
def test_bucketize_by_destination_per_rank_matches_jax(p, cap):
    """Per rank under spmd / vmap: every non-dropped element lands in the
    bucket of its destination, in stable order; counts are clipped to the
    capacity; dropped elements leave the pad value."""
    rng = np.random.RandomState(p + cap)
    n = 13
    data = rng.randint(-99, 99, size=(p, n, 2)).astype(np.int32)
    dest = rng.randint(0, 4, size=(p, n)).astype(np.int32)
    jb, jcnt = jax.vmap(lambda d, r: jc.bucketize_by_destination(
        d, r, 4, cap, pad_value=-1))(data, dest)
    tb, tcnt = tc.spmd(lambda d, r: tc.bucketize_by_destination(
        d, r, 4, cap, pad_value=-1), torch.as_tensor(data),
        torch.as_tensor(dest), axis_name="x")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert tcnt.dtype == torch.int32


# the JAX package's dtypes (without x64 it narrows int64 to int32)
_DTYPES = [np.float32, np.int32, np.uint8, np.float16, np.bool_]


def _tree(seed, as_dict=True):
    rng = np.random.RandomState(seed)
    leaves = []
    for i in range(1 + seed % 4):
        shape = tuple(rng.randint(1, 5, size=rng.randint(0, 3)))
        dt = _DTYPES[(seed + i) % len(_DTYPES)]
        leaves.append(np.asarray(rng.randn(*shape) * 10).astype(dt))
    if as_dict:
        return {f"leaf{i}": v for i, v in enumerate(leaves)}
    return leaves


@pytest.mark.parametrize("seed", range(8))
def test_serialize_roundtrip_and_same_bytes_as_jax(seed):
    tree = _tree(seed, as_dict=seed % 2 == 0)
    ttree = ({k: torch.as_tensor(v) for k, v in tree.items()}
             if isinstance(tree, dict) else [torch.as_tensor(v)
                                             for v in tree])
    s = tc.as_serialized(ttree)
    assert s.buffer.dtype == torch.uint8
    # the archive holds the same bytes as the JAX package's
    np.testing.assert_array_equal(s.buffer.numpy(),
                                  np.asarray(jc.as_serialized(tree).buffer))
    out = tc.deserialize(s)
    leaves = out.values() if isinstance(out, dict) else out
    wants = tree.values() if isinstance(tree, dict) else tree
    for got, want in zip(leaves, wants):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype
    spec = tc.as_deserializable(ttree)
    assert spec.nbytes == s.nbytes and not spec.buffer.any()


def test_serialize_int64_and_bf16_roundtrip():
    tree = [torch.arange(-3, 3, dtype=torch.int64).reshape(2, 3),
            torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            torch.tensor(7, dtype=torch.int16)]
    s = tc.as_serialized(tree)
    assert s.nbytes == 48 + 4 + 2
    for got, want in zip(tc.deserialize(s), tree):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_nested_containers_refused():
    with pytest.raises(TypeError, match="flat"):
        tc.as_serialized({"a": {"b": torch.zeros(2)}})
    with pytest.raises(TypeError, match="flat list or dict"):
        tc.as_serialized(torch.zeros(2))


@pytest.mark.parametrize("transport", ["native", "ring"])
@pytest.mark.parametrize("p", (2, 4))
def test_serialized_travels_through_bcast_and_send_recv(transport, p):
    rng = np.random.RandomState(p)
    w = rng.randn(p, 3).astype(np.float32)
    k = rng.randint(0, 9, size=(p, 2)).astype(np.int64)
    f = rng.randn(p) > 0

    def body(wv, kv, fv):
        comm = tc.Communicator("x", transport=transport)
        s = tc.as_serialized({"w": wv, "k": kv, "f": fv})
        b = comm.bcast(tc.send_recv_buf(s), tc.root(p - 1))
        r = comm.send_recv(tc.send_buf(s),
                           perm=[(i, (i + 1) % p) for i in range(p)])
        return b["w"], b["k"], b["f"], r["w"], r["k"], r["f"]

    bw, bk, bf, rw, rk, rf = tc.spmd(
        body, torch.as_tensor(w), torch.as_tensor(k), torch.as_tensor(f),
        axis_name="x")
    np.testing.assert_array_equal(bw.numpy(), np.broadcast_to(w[-1], w.shape))
    np.testing.assert_array_equal(bk.numpy(), np.broadcast_to(k[-1], k.shape))
    np.testing.assert_array_equal(bf.numpy(), np.broadcast_to(f[-1], f.shape))
    np.testing.assert_array_equal(rw.numpy(), np.roll(w, 1, 0))
    np.testing.assert_array_equal(rk.numpy(), np.roll(k, 1, 0))
    np.testing.assert_array_equal(rf.numpy(), np.roll(f, 1, 0))


@given(st.dictionaries(st.text(max_size=5), st.integers(), max_size=4))
@settings(max_examples=20)
def test_host_archive_roundtrip(d):
    buf = tc.host_pack(d)
    assert buf.dtype == torch.uint8
    np.testing.assert_array_equal(buf.numpy(), jc.host_pack(d))
    assert tc.host_unpack(buf) == d
