"""The port's RG-LRU scan and block against the JAX package's.

The scan's plain version (``repro_torch/kernels/rg_lru/ref.py``
``lru_scan_ref``, what the wrapper computes on a CPU tensor) must match
the JAX package's sequential oracle, its ``associative_scan`` oracle and
the Pallas kernel run in interpret mode within 1e-5 in fp32
(tests/test_kernels.py:86-87) at the shapes of tests/test_kernels.py; the
port's own sequential loop too.  Ragged S and C, which the Pallas kernel
refuses and the port's kernel takes, are held to the sequential oracle,
and a long near-1 decay to the bound of
``test_lru_decay_stability_long_sequence``.  The CUDA kernel's own order
(``lru_chunked_ref``) is held to the same oracles, and its launch plan
(chunk, tile, grid, workspace, 16-byte copies) is checked here, where the
kernel cannot run.  The block
(``repro_torch/models/rglru.py``) is held to the JAX one on carried
weights: the gates, the forward over a sequence and one decode step.  The
CUDA kernel itself is held against the plain version on the card
(``chip_smoke.py`` and ``tests/test_torch_card.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.rglru as jrg  # noqa: E402
from repro.kernels.rg_lru.ref import lru_sequential_ref as jseq  # noqa: E402
from repro.kernels.rg_lru.rg_lru import lru_scan_pallas  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models.rglru as trg  # noqa: E402
from repro_torch.convert import _block  # noqa: E402
from repro_torch.kernels.rg_lru import ops  # noqa: E402
from repro_torch.kernels.rg_lru.ref import (  # noqa: E402
    lru_chunked_ref, lru_sequential_ref)

# (B, S, C, block_t, block_c): tests/test_kernels.py:77-78
SHAPES = [(2, 64, 32, 16, 32), (1, 128, 64, 32, 32), (1, 32, 128, 32, 64),
          (3, 64, 32, 64, 32)]
# S and C that no power-of-two block divides; S = 1; S past several of the
# kernel's 64-step chunks with a ragged last chunk
RAGGED = [(1, 100, 48), (3, 37, 5), (2, 1, 7), (1, 200, 33)]
TOL = 1e-5
FP32 = dict(dtype="float32", param_dtype="float32")


def _inputs(B, S, C, seed=42):
    rng = np.random.RandomState(seed)
    a = np.clip(rng.rand(B, S, C).astype(np.float32), 0.2, 0.999)
    b = rng.randn(B, S, C).astype(np.float32)
    return a, b


def _scan(a, b):
    before = ops.lru_scan.launches
    out = ops.lru_scan(torch.as_tensor(a), torch.as_tensor(b))
    assert ops.lru_scan.launches == before  # CPU: no kernel launch
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("B,S,C,bt,bc", SHAPES)
def test_plain_scan_matches_oracles_and_pallas(B, S, C, bt, bc):
    a, b = _inputs(B, S, C)
    got = _scan(a, b)
    seq = np.asarray(jseq(a, b))
    np.testing.assert_allclose(got, seq, atol=TOL, rtol=TOL)
    asc = np.asarray(jrg.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, asc, atol=TOL, rtol=TOL)
    pallas = np.asarray(lru_scan_pallas(a, b, block_t=bt, block_c=bc,
                                        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    mine = lru_sequential_ref(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(mine.numpy(), seq, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,C", RAGGED)
def test_plain_scan_ragged_shapes(B, S, C):
    a, b = _inputs(B, S, C, seed=S + C)
    np.testing.assert_allclose(_scan(a, b), np.asarray(jseq(a, b)),
                               atol=TOL, rtol=TOL)


def test_decay_stability_long_sequence():
    """a = 0.999 over 512 steps (tests/test_kernels.py:90): finite,
    bounded by b / (1 - a), and equal to the sequential oracle."""
    B, S, C = 1, 512, 16
    a = np.full((B, S, C), 0.999, np.float32)
    b = np.ones((B, S, C), np.float32) * 0.01
    got = _scan(a, b)
    assert np.isfinite(got).all()
    assert (np.abs(got) <= 0.01 / (1 - 0.999) + 1e-3).all()
    np.testing.assert_allclose(got, np.asarray(jseq(a, b)), atol=TOL,
                               rtol=TOL)


# -- the CUDA kernel's order and launch, on the CPU ---------------------------
# lru_chunked_ref is the one-pass kernel's arithmetic order (each chunk's
# map, the fold of the maps in time order, the walk from the carry); the
# kernel itself runs only on the card (tests/test_torch_card.py).
@pytest.mark.parametrize("T", [16, 64])
@pytest.mark.parametrize("B,S,C,bt,bc", SHAPES)
def test_chunked_ref_matches_oracle_and_pallas(B, S, C, bt, bc, T):
    a, b = _inputs(B, S, C)
    got = trg_chunked(a, b, T)
    np.testing.assert_allclose(got, np.asarray(jseq(a, b)), atol=TOL,
                               rtol=TOL)
    pallas = np.asarray(lru_scan_pallas(a, b, block_t=bt, block_c=bc,
                                        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)


# ragged S and C, S < T, S = 1, S a multiple of T and one past it
@pytest.mark.parametrize("T", [7, 64])
@pytest.mark.parametrize("B,S,C", RAGGED + [(1, 64, 8), (2, 65, 12),
                                            (1, 3, 9)])
def test_chunked_ref_ragged_shapes(B, S, C, T):
    a, b = _inputs(B, S, C, seed=S + C + T)
    np.testing.assert_allclose(trg_chunked(a, b, T), np.asarray(jseq(a, b)),
                               atol=TOL, rtol=TOL)


def trg_chunked(a, b, T):
    out = lru_chunked_ref(torch.as_tensor(a), torch.as_tensor(b), T)
    assert out.dtype == torch.float32 and tuple(out.shape) == a.shape
    return out.numpy()


@pytest.mark.parametrize("near_one", [True, False])
def test_chunked_ref_near_one_decay(near_one):
    """A long near-1 decay amplifies each step's fp32 rounding by up to
    1 / (1 - a), so the kernel's order is held to the loop in fp64, no
    worse than twice the fp32 loop's own error plus 1e-5 (chip_smoke.py's
    rule); with a = 0.999, b = 0.01 (tests/test_kernels.py:90 at 5x its
    length) also below b / (1 - a)."""
    B, S, C = 1, 2560, 16
    if near_one:
        rng = np.random.RandomState(3)
        a = (1.0 - 1e-3 * rng.rand(B, S, C)).astype(np.float32)
        b = rng.randn(B, S, C).astype(np.float32)
    else:
        a = np.full((B, S, C), 0.999, np.float32)
        b = np.full((B, S, C), 0.01, np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    exact = lru_sequential_ref(ta.double(), tb.double())
    loop = float((lru_sequential_ref(ta, tb).double() - exact).abs().max())
    got = lru_chunked_ref(ta, tb, ops.CHUNK)
    assert bool(torch.isfinite(got).all())
    assert float((got.double() - exact).abs().max()) <= 2 * loop + TOL
    if not near_one:
        assert float(got.abs().max()) <= 0.01 / (1 - 0.999) + 1e-3


# recurrentgemma-9b's serve prompts (chip_smoke.py HYBRID_PROMPT_LENS) at
# lru_width 4096, then ragged shapes
PLAN_SHAPES = [(1, s, 4096) for s in (100, 256, 512, 1024, 1536, 2048, 2304,
                                      2560)] + [
    (3, 1000, 4100), (3, 37, 5), (2, 1, 7), (1, 64, 4096), (1, 65, 33),
    (70000, 1, 4)]


@pytest.mark.parametrize("B,S,C", PLAN_SHAPES)
def test_kernel_plan(B, S, C):
    """The wrapper's launch: chunks of 64 steps (h's bits depend on it),
    tiles of one warp's 32 channels, a grid within CUDA's limit and
    the workspace the kernel's C interface reads (a 64-bit aggregate and a
    32-bit inclusive carry for each channel of each chunk but the last,
    then the 32-bit tile counter)."""
    p = ops.plan(B, S, C)
    assert p.T == 64 and p.nchunks == -(-S // 64)
    assert p.blocks == B * p.nchunks * -(-C // 32) <= 2**31 - 1
    assert p.ws_bytes == (8 + 4) * (p.nchunks - 1) * B * C + 4


def test_kernel_plan_fills_the_card_at_serve_shapes():
    """recurrentgemma-9b's shortest prompt (2 chunks) still gives about
    two blocks an SM of the H100's 132; the longest, about 39."""
    blocks = {S: ops.plan(1, S, 4096).blocks
              for S in (100, 256, 512, 1024, 1536, 2048, 2304, 2560)}
    assert blocks[100] == 256 and blocks[2560] == 40 * 128
    assert all(n >= 2 * 128 for n in blocks.values())


def test_kernel_plan_refuses_a_grid_past_cuda_limit():
    with pytest.raises(ValueError, match="grid"):
        ops.plan(2**20, 2**18, 32)  # 2**32 blocks


def test_use_vec_needs_quads_and_aligned_bases():
    a = torch.zeros(1, 8, 16)
    assert a.data_ptr() % 16 == 0
    assert ops.use_vec(a, a)
    odd = torch.zeros(1, 8, 15)
    assert not ops.use_vec(odd, odd)  # C % 4 != 0
    raw = torch.zeros(2 * 128 + 1)
    shifted = raw[1:129].view(1, 8, 16)  # 4-byte but not 16-byte aligned
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    assert not ops.use_vec(shifted, a)
    assert not ops.use_vec(a, shifted)


_PTXAS_B7 = """\
ptxas info    : Function properties for _ZN12_GLOBAL__N_112lru_scan_vecENS_4ArgsE
    0 bytes stack frame, {vec_st} bytes spill stores, {vec_ld} bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4 bytes smem
ptxas info    : Function properties for _ZN12_GLOBAL__N_113lru_scan_elemENS_4ArgsE
    0 bytes stack frame, {elem_st} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 4 bytes smem
"""


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_reports_b7_registers_and_spills():
    """The smoke script's [build] report of B7's kernels, by kernel."""
    cs = _chip_smoke()
    log = _PTXAS_B7.format(vec_st=0, vec_ld=0, elem_st=0)
    assert cs.ptxas_by_kernel(log, cs.LRU_KERNELS) == {
        "lru_scan_vec": (40, 0, 0), "lru_scan_elem": (38, 0, 0)}


@pytest.mark.parametrize("log, error", [
    (_PTXAS_B7.format(vec_st=0, vec_ld=0, elem_st=0), None),
    (_PTXAS_B7.format(vec_st=8, vec_ld=0, elem_st=0), "spill"),
    (_PTXAS_B7.format(vec_st=0, vec_ld=8, elem_st=0), "spill"),
    (_PTXAS_B7.format(vec_st=0, vec_ld=0, elem_st=4), "spill"),
    (_PTXAS_B7.format(vec_st=0, vec_ld=0, elem_st=0).split(
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_113"
        "lru_scan_elem")[0], "missing"),
], ids=["clean", "vec_stores", "vec_loads", "elem_stores", "elem_missing"])
def test_chip_smoke_b7_spill_check(log, error):
    """The smoke script's [build] check: both of B7's kernels in the ptxas
    report with no spill."""
    cs = _chip_smoke()
    if error is None:
        cs.check_spills("B7", log, cs.LRU_KERNELS)
    else:
        with pytest.raises(AssertionError, match=error):
            cs.check_spills("B7", log, cs.LRU_KERNELS)


def test_wrapper_refuses_other_devices_and_bad_inputs():
    a = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lru_scan(a, a)
    with pytest.raises(ValueError, match="float32"):
        ops._check(torch.zeros(1, 4, 3, dtype=torch.bfloat16),
                   torch.zeros(1, 4, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\(B, S, C\)"):
        ops._check(torch.zeros(1, 4, 3), torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 3, 4).transpose(1, 2)
        ops._check(x, x)


def _block_pair(seed=0):
    """The JAX block on its own init, with the ``lru`` vectors redrawn
    from a numpy seed so the gates span (0, 1); carried to the port."""
    jc = dataclasses.replace(
        jconfigs.get_config("recurrentgemma-9b", smoke=True), **FP32)
    tc = dataclasses.replace(
        tconfigs.get_config("recurrentgemma-9b", smoke=True), **FP32)
    jp = jrg.init_rglru_block(jax.random.PRNGKey(seed), jc)
    rng = np.random.RandomState(seed)
    w = jc.lru_width
    jp["lru"] = {k: jnp.asarray(rng.randn(w).astype(np.float32) * s)
                 for k, s in (("w_a", 1.0), ("b_a", 1.0), ("w_x", 1.0),
                              ("b_x", 1.0))}
    jp["lru"]["lam"] = jnp.asarray(rng.uniform(-2.0, 4.0, w)
                                   .astype(np.float32))
    tp = _block(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def test_gates_match_reference():
    jc, tc, jp, tp = _block_pair()
    x = np.random.RandomState(1).randn(2, 9, jc.lru_width).astype(np.float32)
    ja, jb = jrg.rglru_gates(jp["lru"], jnp.asarray(x))
    ta, tb = trg.rglru_gates(tp["lru"], torch.as_tensor(x))
    assert ta.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 16, 70])
def test_block_forward_matches_reference(S):
    jc, tc, jp, tp = _block_pair(seed=2)
    x = np.random.RandomState(S).randn(2, S, jc.d_model).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jrg.rglru_block_forward(p, v, jc))(
        jp, jnp.asarray(x)))
    got = trg.rglru_block_forward(tp, torch.as_tensor(x), tc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    out, hseq, rec = trg.rglru_block_prefill(tp, torch.as_tensor(x), tc)
    assert torch.equal(out, got)
    assert hseq.shape == (2, S, jc.lru_width) and hseq.dtype == torch.float32
    assert rec.shape == (2, S, jc.lru_width)


def test_block_decode_matches_reference():
    jc, tc, jp, tp = _block_pair(seed=3)
    rng = np.random.RandomState(4)
    B, w, K = 3, jc.lru_width, jc.ssm_conv_width
    x = rng.randn(B, 1, jc.d_model).astype(np.float32)
    state = {"h": rng.randn(B, w).astype(np.float32),
             "conv": rng.randn(B, K - 1, w).astype(np.float32)}
    jout, jst = jrg.rglru_block_decode(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state), jc)
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    tout, tst = trg.rglru_block_decode(tp, torch.as_tensor(x), tstate, tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                               atol=1e-5, rtol=1e-5)
    # the window shifts by one row: the old rows exactly, the new row is
    # rec_proj's output (matrix products round in other orders)
    np.testing.assert_array_equal(tst["conv"][:, :-1].numpy(),
                                  state["conv"][:, 1:])
    np.testing.assert_allclose(tst["conv"].numpy(), np.asarray(jst["conv"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tstate["h"].numpy(), state["h"])


def test_init_block_and_state_match_reference_layout():
    for fp32 in (False, True):
        kw = FP32 if fp32 else {}
        jc = dataclasses.replace(
            jconfigs.get_config("recurrentgemma-9b", smoke=True), **kw)
        tc = dataclasses.replace(
            tconfigs.get_config("recurrentgemma-9b", smoke=True), **kw)
        jp = jax.tree.map(np.asarray, jrg.init_rglru_block(
            jax.random.PRNGKey(0), jc))
        mine = trg.init_rglru_block(torch.Generator().manual_seed(0), tc,
                                    device="cpu")
        carried = _block(jp, "cpu")
        flat = lambda t: {k: v for k, v in _leaves(t)}
        assert flat(mine).keys() == flat(carried).keys()
        for k, v in flat(mine).items():
            c = flat(carried)[k]
            assert v.shape == c.shape and v.dtype == c.dtype, k
        # the same linspace (the two frameworks round its steps apart)
        np.testing.assert_allclose(mine["lru"]["lam"].numpy(),
                                   jp["lru"]["lam"], rtol=1e-6)
        jst = jrg.init_rglru_decode_state(jc, 2)
        tst = trg.init_rglru_decode_state(tc, 2, "cpu")
        for k in ("h", "conv"):
            assert tuple(tst[k].shape) == jst[k].shape
            assert str(tst[k].dtype)[6:] == str(jst[k].dtype)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v
