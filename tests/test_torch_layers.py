"""Each layer function of the port against its JAX counterpart (fp32, 1e-5).

Inputs come from numpy with a seed and go to both packages.  Named traps:
``rms_norm`` scales by ``(1 + w)`` (layers.py:32-37), rotary is
rotate-half in fp32 (layers.py:47-61), ``gelu`` is the tanh form, and the
attention is chosen by device, never by a config flag (layers.py:250).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jl  # noqa: E402
import repro_torch.models.layers as tl  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import ModelConfig as TConfig  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=48, vocab_size=64, qkv_bias=True,
           rope_theta=1e4, dtype="float32", param_dtype="float32",
           attn_chunk=8)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jdense(d):
    return {k: jnp.asarray(v.T if k == "w" else v) for k, v in d.items()}


def _tdense(d):
    return {k: _t(v) for k, v in d.items()}


def _dense_params(d_in, d_out, bias, seed):
    p = {"w": _rand(d_out, d_in, seed=seed) / math.sqrt(d_in)}
    if bias:
        p["b"] = _rand(d_out, seed=seed + 1)
    return p


def test_rms_norm_scales_by_one_plus_w():
    x, w = _rand(2, 5, 32), _rand(32, seed=1)
    got = tl.rms_norm(_t(x), _t(w), 1e-6).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.rms_norm(x, w, 1e-6)), **TOL)
    normed = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)
    assert not np.allclose(got, normed * w, atol=1e-3)  # not HF's plain w


@pytest.mark.parametrize("shape", [(7,), (2, 7)])
def test_make_rotary(shape):
    pos = np.arange(int(np.prod(shape))).reshape(shape) * 37
    jc, js = jl.make_rotary(jnp.asarray(pos), 16, 1e6)
    tc, ts = tl.make_rotary(_t(pos), 16, 1e6)
    assert tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("batched_cos", [False, True])
def test_apply_rotary_rotate_half(batched_cos):
    x = _rand(2, 6, 4, 16)
    pos = np.arange(6)
    if batched_cos:
        pos = np.stack([pos, pos + 3])
    cos, sin = jl.make_rotary(jnp.asarray(pos), 16)
    want = np.asarray(jl.apply_rotary(jnp.asarray(x), cos, sin))
    got = tl.apply_rotary(_t(x), _t(cos), _t(sin)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # rotate-half pairs dimension i with i + D/2, not with i + 1
    c, s = np.asarray(cos), np.asarray(sin)
    c = c[None, :, None] if c.ndim == 2 else c[:, :, None]
    s = s[None, :, None] if s.ndim == 2 else s[:, :, None]
    inter = np.empty_like(x)
    inter[..., 0::2] = x[..., 0::2] * c - x[..., 1::2] * s
    inter[..., 1::2] = x[..., 1::2] * c + x[..., 0::2] * s
    assert not np.allclose(got, inter, atol=1e-3)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    p = _dense_params(32, 24, bias, 3)
    x = _rand(3, 5, 32, seed=4)
    np.testing.assert_allclose(tl.dense(_tdense(p), _t(x)).numpy(),
                               np.asarray(jl.dense(_jdense(p), x)), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    p = {n: _dense_params(a, b, False, s) for n, a, b, s in
         (("wi", 32, 48, 5), ("wg", 32, 48, 7), ("wo", 48, 32, 9))}
    x = _rand(2, 5, 32, seed=10)
    got = tl.gated_mlp({k: _tdense(v) for k, v in p.items()}, _t(x), act)
    want = jl.gated_mlp({k: _jdense(v) for k, v in p.items()}, x, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "B,Sq,Skv,H,KV,D,causal,window,chunk,q_offset",
    [
        (2, 16, 16, 4, 2, 8, True, None, 8, 0),
        (1, 20, 20, 4, 1, 8, True, 5, 8, 0),     # MQA + window, ragged chunk
        (1, 8, 24, 4, 4, 16, False, None, 16, 0),  # cross-attention style
        (1, 6, 6, 2, 2, 8, True, None, 4, 3),     # offset positions
        (1, 4, 4, 2, 1, 8, True, 0, 4, 0),        # window 0: rows fully masked
    ],
)
def test_chunked_attention(B, Sq, Skv, H, KV, D, causal, window, chunk,
                           q_offset):
    q, k, v = _rand(B, Sq, H, D), _rand(B, Skv, KV, D, seed=1), \
        _rand(B, Skv, KV, D, seed=2)
    kw = dict(q_offset=q_offset, causal=causal, window=window, chunk=chunk)
    want = np.asarray(jl.chunked_attention(q, k, v, **kw))
    got = tl.chunked_attention(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _attn_params(seed=20):
    c = JConfig(**CFG)
    return {
        "wq": _dense_params(c.d_model, c.q_dim, True, seed),
        "wk": _dense_params(c.d_model, c.kv_dim, True, seed + 2),
        "wv": _dense_params(c.d_model, c.kv_dim, True, seed + 4),
        "wo": _dense_params(c.q_dim, c.d_model, False, seed + 6),
    }


def test_project_qkv():
    p = _attn_params()
    x = _rand(2, 9, 32, seed=30)
    jq = jl._project_qkv({k: _jdense(v) for k, v in p.items()}, x,
                         JConfig(**CFG), jnp.arange(9))
    tq = tl._project_qkv({k: _tdense(v) for k, v in p.items()}, _t(x),
                         TConfig(**CFG), torch.arange(9))
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_forward(window):
    p = _attn_params()
    x = _rand(2, 11, 32, seed=31)
    want = jl.attention_forward({k: _jdense(v) for k, v in p.items()}, x,
                                JConfig(**CFG), window=window)
    before = flash_ops.flash_attention.launches
    got = tl.attention_forward({k: _tdense(v) for k, v in p.items()}, _t(x),
                               TConfig(**CFG), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert flash_ops.flash_attention.launches == before


def test_attention_is_chosen_by_device_not_config():
    """layers.py:250 gates the kernel on ``cfg.use_pallas`` and a TPU; the
    port has no such flag and sends every CUDA tensor to the kernel."""
    assert "use_pallas" not in {f.name for f in dataclasses.fields(TConfig)}
    assert tl.uses_kernel("cuda") and tl.uses_kernel(torch.device("cuda", 1))
    assert not tl.uses_kernel("cpu")
    q = _rand(1, 8, 4, 8)
    kv = _rand(1, 8, 2, 8, seed=1)
    before = flash_ops.flash_attention.launches
    got = tl._attend(_t(q), _t(kv), _t(kv), TConfig(**CFG), causal=True,
                     window=None, force_ref=False)
    want = tl.chunked_attention(_t(q), _t(kv), _t(kv), chunk=CFG["attn_chunk"])
    assert torch.equal(got, want)  # CPU: the JAX package's CPU path
    assert flash_ops.flash_attention.launches == before


def test_init_shapes_follow_torch_layout():
    g = torch.Generator().manual_seed(0)
    c = TConfig(**CFG)
    p = tl.init_attention(g, c)
    assert p["wq"]["w"].shape == (c.q_dim, c.d_model)
    assert p["wo"]["w"].shape == (c.d_model, c.q_dim)
    assert torch.count_nonzero(p["wk"]["b"]) == 0
    m = tl.init_mlp(g, 32, 48, dtype="bfloat16")
    assert m["wi"]["w"].dtype == torch.bfloat16
    w = tl.init_dense(g, 400, 300)["w"].float()
    assert float(w.abs().max()) <= 2.0 / math.sqrt(400) + 1e-2
    assert abs(float(w.std()) * math.sqrt(400) - 0.88) < 0.05  # trunc ±2σ
