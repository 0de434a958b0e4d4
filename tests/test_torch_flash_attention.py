"""The flash-attention kernel's plain version against the JAX package.

On the CPU the port's wrapper computes its plain version
(``repro_torch/kernels/flash_attention/ref.py``); it must match the Pallas
kernel run in interpret mode and the naive ``attention_ref`` over the
grid of tests/test_kernels.py, within 2e-5 in fp32 (3e-2 in bf16, as
tests/test_kernels.py:40).  The CUDA kernel itself is held against the
same plain version on the card (``chip_smoke.py`` and
``tests/test_torch_card.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_pallas,
)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)

GRID = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 4, 1, 32, True, 48),     # MQA + sliding window
    (2, 100, 100, 2, 2, 64, True, None),   # non-multiple -> padding
    (1, 64, 192, 4, 4, 64, False, None),   # cross-attention style
    (1, 128, 128, 8, 2, 128, True, 32),    # GQA 4:1, small window
]


def _inputs(B, Sq, Skv, H, KV, D, seed=42):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Skv, KV, D).astype(np.float32),
            rng.randn(B, Skv, KV, D).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", GRID)
def test_plain_version_matches_pallas_and_ref(B, Sq, Skv, H, KV, D, causal,
                                              window):
    q, k, v = _inputs(B, Sq, Skv, H, KV, D)
    before = ops.flash_attention.launches
    got = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=causal,
                              window=window).numpy()
    assert ops.flash_attention.launches == before  # CPU: no kernel launch
    pallas = flash_attention_pallas(q, k, v, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True)
    naive = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(naive), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5),
                                        (jnp.bfloat16, 3e-2)])
def test_plain_version_dtypes(dtype, atol):
    q, k, v = _inputs(1, 128, 128, 4, 2, 64)
    qd, kd, vd = (jnp.asarray(x, dtype) for x in (q, k, v))
    want = np.asarray(flash_attention_pallas(qd, kd, vd, interpret=True),
                      np.float32)
    tdt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    got = flash_attention_ref(*(torch.as_tensor(np.array(x, np.float32))
                                .to(tdt) for x in (qd, kd, vd)))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=atol)


def test_fully_masked_rows_are_zero():
    """window=0 masks every key: the kernel's semantics give 0 (the
    -1e30 fill and the 1e-30 floor), as the Pallas kernel does."""
    q, k, v = _inputs(1, 64, 64, 2, 2, 64, seed=3)
    got = flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), window=0)
    assert torch.count_nonzero(got) == 0
    pallas = flash_attention_pallas(q, k, v, window=0, interpret=True)
    assert not np.asarray(pallas).any()


def test_block_size_does_not_change_the_function():
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 96, 96, 4, 2, 64))
    a = flash_attention_ref(q, k, v, window=40, block_k=64)
    b = flash_attention_ref(q, k, v, window=40, block_k=16)
    torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-6)


def test_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(1, 8, 4, 48)
    kv = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(q, kv, kv, None)
    q = torch.zeros(1, 8, 3, 64)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="multiple"):
        ops._check(q, kv, kv, None)
    q = torch.zeros(1, 8, 4, 64, dtype=torch.float16)
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        ops._check(q, kv, kv, None)
    q = torch.zeros(1, 4, 8, 64).transpose(1, 2)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q, kv, kv, None)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(kv.to("meta"), kv.to("meta"), kv.to("meta"))


# head_dim 256 (recurrentgemma's local attention, MQA 16:1 over a window):
# causal, a window shorter than S, a ragged S, and a window past S
GRID_256 = [
    (1, 96, 96, 16, 1, 256, True, 40),
    (1, 130, 130, 4, 1, 256, True, None),
    (2, 64, 64, 8, 2, 256, True, 100),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", GRID_256)
@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5),
                                        (jnp.bfloat16, 3e-2)])
def test_plain_version_head_dim_256(B, Sq, Skv, H, KV, D, causal, window,
                                    dtype, atol):
    """The plain version is general in D: at 256 it matches the naive
    ``attention_ref`` within the reference's tolerances
    (tests/test_kernels.py:37,40), fp32 and bf16."""
    q, k, v = _inputs(B, Sq, Skv, H, KV, D, seed=7)
    qd, kd, vd = (jnp.asarray(x, dtype) for x in (q, k, v))
    naive = np.asarray(attention_ref(qd, kd, vd, causal=causal,
                                     window=window), np.float32)
    tdt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    got = ops.flash_attention(*(torch.as_tensor(np.array(x, np.float32))
                                .to(tdt) for x in (qd, kd, vd)),
                              causal=causal, window=window)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), naive, atol=atol,
                               rtol=atol)


def test_head_dim_256_is_taken():
    """The kernel's head_dim 256 instance (B5b): the wrapper's checks pass
    it, MQA included."""
    q = torch.zeros(1, 8, 16, 256, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 1, 256, dtype=torch.bfloat16)
    ops._check(q, kv, kv, 2048)
    assert ops._HEAD_DIMS == (64, 128, 256)
