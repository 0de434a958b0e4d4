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
    # the bf16 kernel reads q, k, v with TMA: 16-byte aligned only
    off = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16)[1:]
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    ops._check(q, kv, kv, None)
    with pytest.raises(ValueError, match="aligned"):
        ops._check(q, off.view(1, 8, 2, 64), kv, None)


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


# -- the bf16 kernel's precision argument -------------------------------------
# The bf16 CUDA kernel multiplies on bf16 tensor cores with fp32 sums: S from
# bf16 q, k (products exact in fp32), and P.V with P split into two bf16
# halves, P = bf16(P) + bf16(P - bf16(P)).  These tests emulate that
# arithmetic on the CPU and hold it to the same bound as the card checks:
# within half a bf16 ulp (2^-8 |x|) of the plain version in fp32 on the
# same inputs, plus 1e-5; and show that P rounded once to bf16 misses it.
BF16_HALF_ULP, BF16_FP32_ATOL = 2.0 ** -8, 1e-5


def _emulate_tensor_core_kernel(q, k, v, *, causal, window, split_p,
                                block_k=64):
    """The bf16 kernel's arithmetic in fp32 on the CPU: 64-key tiles, the
    online softmax in the log2 domain, O += P_hi.V + P_lo.V (or bf16(P).V
    when not ``split_p``), output rounded to bf16 once."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale_log2 = (1.0 / np.sqrt(D)) * np.log2(np.e)
    qf = q.float().reshape(B, Sq, KV, G, D)
    m = torch.full((B, Sq, KV, G), -1e30)
    l = torch.zeros((B, Sq, KV, G))
    acc = torch.zeros((B, Sq, KV, G, D))
    q_pos = torch.arange(Sq)[:, None]
    for start in range(0, Skv, block_k):
        kb = k[:, start:start + block_k].float()
        vb = v[:, start:start + block_k].float()
        x = torch.einsum("bqkgd,bckd->bqkgc", qf, kb) * scale_log2
        k_pos = start + torch.arange(kb.shape[1])[None, :]
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        mask = mask[None, :, None, None, :]
        x = torch.where(mask, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        p = torch.where(mask, torch.exp2(x - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bqkgc,bckd->bqkgd", hi, vb)
        if split_p:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bqkgc,bckd->bqkgd", lo, vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Sq, H, D).to(torch.bfloat16)


def _half_ulp_excess(got, want32):
    return float(((got.float() - want32).abs()
                  - BF16_HALF_ULP * want32.abs()).max())


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("window", [None, 96])
def test_split_p_keeps_bf16_within_half_ulp_of_fp32(D, window):
    """At a serve-like shape (S 256, MQA 8:1), P as two bf16 halves keeps
    the bf16 output within half an ulp of fp32; P rounded once does not."""
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _inputs(1, 256, 256, 8, 1, D, seed=11))
    want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=True, window=window)
    split = _emulate_tensor_core_kernel(q, k, v, causal=True, window=window,
                                        split_p=True)
    once = _emulate_tensor_core_kernel(q, k, v, causal=True, window=window,
                                       split_p=False)
    assert _half_ulp_excess(split, want32) <= BF16_FP32_ATOL
    assert _half_ulp_excess(once, want32) > BF16_FP32_ATOL


_PTXAS = """\
ptxas info    : Function properties for _Z12flash_fwd_tcILi64EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _Z12flash_fwd_tcILi128EEv
    0 bytes stack frame, {s128} bytes spill stores, {l128} bytes spill loads
ptxas info    : Function properties for _Z9flash_fwdILi256EEv
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Function properties for _Z12flash_fwd_tcILi256EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_chip_smoke_reports_tc_registers_and_spills():
    """The smoke script's [build] report of the three bf16 instances, by
    the template argument in their mangled names; the fp32 SIMT instance
    is not among them, and an instance whose report gives no registers
    still counts."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.ptxas_by_kernel(
        _PTXAS.format(s128=4, l128=8), chip_smoke.FLASH_TC_KERNELS) == {
        "flash_fwd_tcILi64E": (168, 0, 0), "flash_fwd_tcILi128E": (None, 4, 8),
        "flash_fwd_tcILi256E": (None, 0, 0)}


@pytest.mark.parametrize("log, error", [
    (_PTXAS.format(s128=0, l128=0), None),
    (_PTXAS.format(s128=4, l128=0), "spills"),
    (_PTXAS.format(s128=0, l128=8), "spills"),
    (_PTXAS.format(s128=0, l128=0).split("ptxas info    : Function "
                                         "properties for _Z12flash_fwd_tc"
                                         "ILi256")[0], "expected 3"),
])
def test_chip_smoke_spill_check(log, error):
    """The smoke script's build check: every bf16 tensor-core instance
    without spills (the fp32 SIMT instance may spill), all three present."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    if error is None:
        chip_smoke.check_spills("B5", log, chip_smoke.FLASH_TC_KERNELS)
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke.check_spills("B5", log, chip_smoke.FLASH_TC_KERNELS)
