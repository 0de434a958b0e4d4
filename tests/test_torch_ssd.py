"""The port's SSD scan and mixer against the JAX package's.

The plain scan (``repro_torch/kernels/ssd/ref.py``) must match the JAX
package's chunked oracle within 1e-5 in fp32 (the same arithmetic, summed
in another order), and the Pallas kernel run in interpret mode, the
sequential recurrence and the port's own sequential recurrence within
3e-4 (tests/test_kernels.py:71-72), over the shapes of
tests/test_kernels.py plus a prompt shorter than the chunk.  The mixer
(``repro_torch/models/ssd.py``) is held to the JAX one on carried weights
for both projection layouts.  The CUDA kernel itself is held against the
plain version on the card (``chip_smoke.py`` and
``tests/test_torch_card.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.ssd as jssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_sequential_ref as jseq  # noqa: E402
from repro.kernels.ssd.ssd import ssd_scan_pallas  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models.ssd as tssd  # noqa: E402
from repro_torch.convert import _block  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_scan_ref,
    ssd_sequential_ref,
)
from repro_torch.models.layers import causal_conv1d  # noqa: E402

# (B, S, H, P, G, N, Q): tests/test_kernels.py's shapes, then S < Q (one
# chunk of length S, as the serve path's 100-token prompt) and G > 1 with
# several chunks
SHAPES = [
    (2, 64, 4, 16, 1, 32, 16),
    (1, 128, 2, 32, 2, 16, 32),
    (1, 64, 8, 8, 1, 8, 64),
    (2, 96, 4, 16, 4, 16, 32),
    (1, 20, 4, 8, 2, 16, 32),
]
FP32 = dict(dtype="float32", param_dtype="float32")


def _inputs(B, S, H, P, G, N, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32) * 0.5
    a = np.clip(rng.rand(B, S, H).astype(np.float32), 0.3, 0.99)
    Bm = rng.randn(B, S, G, N).astype(np.float32) * 0.3
    C = rng.randn(B, S, G, N).astype(np.float32) * 0.3
    return x, a, Bm, C


def _t(*arrays):
    return [torch.as_tensor(np.asarray(v)) for v in arrays]


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SHAPES)
def test_plain_scan_matches_oracle_and_pallas(B, S, H, P, G, N, Q):
    x, a, Bm, C = _inputs(B, S, H, P, G, N)
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(*_t(x, a, Bm, C), chunk=Q).numpy()
    assert ops.ssd_scan.launches == before  # CPU: no kernel launch
    oracle = np.asarray(jssd.ssd_scan_ref(x, a, Bm, C, chunk=Q))
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)
    pallas = np.asarray(ssd_scan_pallas(x, a, Bm, C, chunk=Q,
                                        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3e-4, rtol=3e-4)
    seq = np.asarray(jseq(x, a, Bm, C))
    np.testing.assert_allclose(got, seq, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SHAPES[:2] + SHAPES[3:])
def test_sequential_recurrence_matches_reference(B, S, H, P, G, N, Q):
    x, a, Bm, C = _inputs(B, S, H, P, G, N, seed=1)
    got = ssd_sequential_ref(*_t(x, a, Bm, C)).numpy()
    np.testing.assert_allclose(got, np.asarray(jseq(x, a, Bm, C)),
                               atol=1e-5, rtol=1e-5)
    chunked = ssd_scan_ref(*_t(x, a, Bm, C), chunk=Q).numpy()
    np.testing.assert_allclose(chunked, got, atol=3e-4, rtol=3e-4)


def test_plain_scan_bf16_rounds_once():
    """bf16 inputs: computed in fp32 and rounded to bf16 once, so within
    half a bf16 ulp of the fp32 result on the same (bf16) inputs."""
    x, a, Bm, C = _t(*_inputs(1, 64, 4, 16, 1, 32))
    xb, Bb, Cb = (v.to(torch.bfloat16) for v in (x, Bm, C))
    got = ssd_scan_ref(xb, a, Bb, Cb, chunk=16)
    assert got.dtype == torch.bfloat16
    want = ssd_scan_ref(xb.float(), a, Bb.float(), Cb.float(), chunk=16)
    excess = (got.float() - want).abs() - 2.0 ** -8 * want.abs()
    assert float(excess.max()) <= 1e-6


@pytest.mark.parametrize("S,chunk", [(100, 32), (12, 8)])
def test_chunk_rule_raises_in_both_packages(S, chunk):
    x, a, Bm, C = _inputs(1, S, 2, 4, 1, 4)
    with pytest.raises(AssertionError, match="divisible"):
        jssd.ssd_scan_ref(x, a, Bm, C, chunk=chunk)
    with pytest.raises(ValueError, match="divisible"):
        ssd_scan_ref(*_t(x, a, Bm, C), chunk=chunk)
    with pytest.raises(ValueError, match="divisible"):
        ops._check(*_t(x, a, Bm, C), chunk)


def test_kernel_rejects_what_it_does_not_take():
    x, a, Bm, C = _t(*_inputs(1, 16, 4, 8, 2, 8))
    with pytest.raises(ValueError, match="dtypes"):
        ops._check(x.to(torch.bfloat16), a, Bm, C, 8)
    with pytest.raises(ValueError, match="dtypes"):
        ops._check(x, a.double(), Bm, C, 8)
    with pytest.raises(ValueError, match="multiple"):
        ops._check(x[:, :, :3].contiguous(), a[:, :, :3].contiguous(), Bm,
                   C, 8)
    strided = torch.empty(1, 16, 8, 2).transpose(2, 3).copy_(Bm)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(x, a, strided, C, 8)
    with pytest.raises(ValueError, match="kernel's"):
        ops._check(*_t(*_inputs(1, 256, 2, 4, 1, 4)), 256)
    with pytest.raises(ValueError, match=r"a \("):
        ops._check(x, a[:, :8], Bm, C, 8)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(*(v.to("meta") for v in (x, a, Bm, C)), chunk=8)
    assert ops._check(x, a, Bm, C, 8) == 8


def test_causal_conv1d_matches_reference():
    from repro.models.layers import causal_conv1d as jconv

    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    st = rng.randn(2, 3, 6).astype(np.float32)
    for state in (None, st):
        jy, js = jconv(x, w, state)
        ty, ts = causal_conv1d(*_t(x, w), None if state is None
                               else torch.as_tensor(state))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _mixer(split, seed=0):
    jc = dataclasses.replace(jconfigs.get_config("mamba2-370m", smoke=True),
                             ssm_split_proj=split, **FP32)
    tc = dataclasses.replace(tconfigs.get_config("mamba2-370m", smoke=True),
                             ssm_split_proj=split, **FP32)
    jp = jssd.init_ssd_block(jax.random.PRNGKey(seed), jc)
    tp = _block(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("split", [False, True])
def test_block_forward_matches_reference(split):
    jc, tc, jp, tp = _mixer(split)
    x = np.random.RandomState(3).randn(2, 16, jc.d_model).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jssd.ssd_block_forward(p, v, jc))(
        jp, jnp.asarray(x)))
    got = tssd.ssd_block_forward(tp, torch.as_tensor(x), tc).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("split", [False, True])
def test_block_decode_matches_reference(split):
    jc, tc, jp, tp = _mixer(split, seed=1)
    rng = np.random.RandomState(4)
    jstate = jssd.init_ssd_decode_state(jc, 2)
    tstate = tssd.init_ssd_decode_state(tc, 2, "cpu")
    step = jax.jit(lambda p, v, s: jssd.ssd_block_decode(p, v, s, jc))
    for _ in range(5):
        x = rng.randn(2, 1, jc.d_model).astype(np.float32)
        jy, jstate = step(jp, jnp.asarray(x), jstate)
        ty, tstate = tssd.ssd_block_decode(tp, torch.as_tensor(x), tstate, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tstate["ssm"].numpy(),
                                   np.asarray(jstate["ssm"]), atol=1e-5,
                                   rtol=1e-4)
        # raw projections: the two frameworks' matmuls round differently
        np.testing.assert_allclose(tstate["conv"].numpy(),
                                   np.asarray(jstate["conv"]), atol=1e-5,
                                   rtol=1e-5)


def test_split_layout_equals_fused_on_the_same_weights():
    """A split block whose weights are the fused block's column blocks
    gives the fused block's output: the conv is depthwise, so convolving
    the concatenated channels is the three convs."""
    jc, tc, jp, tp = _mixer(False, seed=2)
    di, GN, H = tc.ssm_inner, tc.ssm_groups * tc.ssm_state, tc.ssm_heads
    w, cw = tp["in_proj"]["w"], tp["conv_w"]
    cuts = [di, di, GN, GN, H]
    wz, wx, wB, wC, wdt = torch.split(w, cuts, dim=0)
    cx, cb, cc = torch.split(cw, [di, GN, GN], dim=1)
    split = {k: v for k, v in tp.items() if k not in ("in_proj", "conv_w")}
    split.update(wz={"w": wz}, wx={"w": wx}, wB={"w": wB}, wC={"w": wC},
                 wdt={"w": wdt}, conv_x=cx, conv_b=cb, conv_c=cc)
    x = torch.as_tensor(np.random.RandomState(5).randn(1, 8, tc.d_model)
                        .astype(np.float32))
    torch.testing.assert_close(
        tssd.ssd_block_forward(split, x, dataclasses.replace(
            tc, ssm_split_proj=True)),
        tssd.ssd_block_forward(tp, x, tc), atol=1e-5, rtol=1e-5)


def test_init_block_layouts_match_reference_shapes():
    for split in (False, True):
        jc, tc, jp, tp = _mixer(split)
        mine = tssd.init_ssd_block(torch.Generator().manual_seed(0), tc,
                                   device="cpu")
        carried = _block(jax.tree.map(np.asarray, jp), "cpu")
        assert set(mine) == set(carried)
        for k in mine:
            a = mine[k]["w"] if isinstance(mine[k], dict) else mine[k]
            b = carried[k]["w"] if isinstance(carried[k], dict) else carried[k]
            assert a.shape == b.shape and a.dtype == b.dtype, k


# -- the bf16 kernel's precision argument -------------------------------------
# The bf16 CUDA kernel puts the state path on bf16 tensor cores with fp32
# sums: (B u)^T x and C S_prev, where the fp32 operand (B u, S_prev) goes
# in as two bf16 halves, v = bf16(v) + bf16(v - bf16(v)).  The intra-chunk
# path, W = C B^T * exp(la_i - la_j) and W x, stays in fp32 FMAs in the
# plain version's order (a tensor-core W x changes the order of the sums,
# which the bf16 model's logits do not tolerate; PERF.md, PR 21).  These
# tests emulate that arithmetic on the CPU and hold it to the card's
# bound: within half a bf16 ulp (2^-8 |y|) of the plain version in fp32 on
# the same inputs, plus 3e-4 (chip_smoke.py's SSD_TOL); and show that each
# tensor-core operand rounded once to bf16 misses it.
SSD_TOL, BF16_HALF_ULP = 3e-4, 2.0 ** -8
KERNEL = {"Bu": 2, "S_prev": 2, "W": 0}  # bf16 pieces; 0: fp32, no rounding


def _bf16_inputs(B, S, H, P, G, N, fast, seed=7):
    """chip_smoke.py's SSD inputs: with ``fast`` every other head decays as
    exp(-(4 + 16 u)), mamba2's fast heads."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32) * 0.5
    a = np.clip(rng.rand(B, S, H).astype(np.float32), 0.3, 0.99)
    if fast:
        a[:, :, ::2] = np.exp(-(4 + 16 * rng.rand(B, S, (H + 1) // 2)))
    Bm = rng.randn(B, S, G, N).astype(np.float32) * 0.3
    C = rng.randn(B, S, G, N).astype(np.float32) * 0.3
    x, a, Bm, C = _t(x, a.astype(np.float32), Bm, C)
    return x.to(torch.bfloat16), a, Bm.to(torch.bfloat16), C.to(torch.bfloat16)


def _emulate_tensor_core_scan(x, a, Bm, C, Q, pieces=KERNEL):
    """The bf16 kernel's arithmetic in fp32 on the CPU.  ``pieces`` maps
    each fp32 operand (B u, S_prev, W) to the bf16 pieces it is multiplied
    as (0: kept in fp32); the output is rounded once."""
    def operand(v, name):
        out, rest = torch.zeros_like(v), v
        for _ in range(pieces[name]):
            piece = rest.to(torch.bfloat16).float()
            out, rest = out + piece, rest - piece
        return out if pieces[name] else v

    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, S // Q
    xc = x.float().reshape(Bsz, nc, Q, H, P)
    Bc = Bm.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, 3)
    Cc = C.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, 3)
    la = torch.cumsum(torch.log(torch.clamp_min(
        a.reshape(Bsz, nc, Q, H), 1e-37)), dim=2)
    # (a) chunk states from B u in pieces
    u = torch.exp(la[:, :, -1:] - la)
    cs = torch.einsum("bnqhk,bnqhp->bnhkp",
                      operand(Bc * u[..., None], "Bu"), xc)
    # (b) the fp32 carry
    state = torch.zeros((Bsz, H, N, P))
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * torch.exp(la[:, n, -1])[..., None, None] + cs[:, n]
    s_prev = operand(torch.stack(prev, 1), "S_prev")
    # (c) W from C B^T, masked before exp
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :,
                                                          None]
    w = torch.einsum("bnihk,bnjhk->bnijh", Cc, Bc) * torch.exp(
        torch.where(causal, seg, -torch.inf))
    y = (torch.einsum("bnijh,bnjhp->bnihp", operand(w, "W"), xc)
         + torch.exp(la)[..., None]
         * torch.einsum("bnihk,bnhkp->bnihp", Cc, s_prev))
    return y.reshape(Bsz, S, H, P).to(torch.bfloat16)


@pytest.mark.parametrize("fast", [False, True], ids=["mild", "fast"])
@pytest.mark.parametrize("pieces, within", [
    (KERNEL, True),                          # the kernel
    (dict(KERNEL, W=2), True),               # W in halves on the cores too
    (dict(KERNEL, Bu=1), False),             # B u rounded once
    (dict(KERNEL, S_prev=1), False),         # S_prev rounded once
    (dict(KERNEL, W=1), False),              # W rounded once
], ids=["kernel", "W_halves", "Bu_once", "S_prev_once", "W_once"])
def test_split_operands_keep_bf16_within_half_ulp_of_fp32(fast, pieces,
                                                          within):
    """mamba2's widths (H 8 of its 32 heads, P 64, N 128, Q 128) over 4
    chunks: the tensor-core operands in two bf16 halves keep the bf16
    output within half an ulp of fp32 plus 3e-4; any one rounded once does
    not."""
    x, a, Bm, C = _bf16_inputs(1, 512, 8, 64, 1, 128, fast)
    want32 = ssd_scan_ref(x.float(), a, Bm.float(), C.float(), chunk=128)
    got = _emulate_tensor_core_scan(x, a, Bm, C, 128, pieces=pieces)
    excess = float(((got.float() - want32).abs()
                    - BF16_HALF_ULP * want32.abs()).max())
    assert (excess <= SSD_TOL) == within, excess


_PTXAS_SSD = """\
ptxas info    : Function properties for _ZN12_GLOBAL__N_13ssd_chunk_outEPK
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 121 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_15ssd_state_carryEPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_13ssd_scan_fp32EPKf
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Function properties for _Z12flash_fwd_tcILi64EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_chip_smoke_reports_b6_registers_and_spills():
    """The smoke script's [build] report of B6's kernels, by kernel."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.ptxas_by_kernel(_PTXAS_SSD, chip_smoke.SSD_KERNELS) == {
        "ssd_chunk_out": (121, 0, 0), "ssd_state_carry": (31, 0, 0),
        "ssd_scan_fp32": (128, 8, 12)}


_PTXAS_B6 = """\
ptxas info    : Function properties for _ZN12_GLOBAL__N_13ssd_chunk_outEPK
    0 bytes stack frame, {out_st} bytes spill stores, {out_ld} bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_15ssd_state_carryEPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_15ssd_chunk_stateEPK
    0 bytes stack frame, 0 bytes spill stores, {state_ld} bytes spill loads
ptxas info    : Used 75 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_13ssd_scan_fp32EPKf
    8 bytes stack frame, {fp32_st} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


@pytest.mark.parametrize("log, error", [
    (_PTXAS_B6.format(out_st=0, out_ld=0, state_ld=0, fp32_st=0), None),
    (_PTXAS_B6.format(out_st=0, out_ld=0, state_ld=0, fp32_st=8), None),
    (_PTXAS_B6.format(out_st=4, out_ld=0, state_ld=0, fp32_st=0), "spill"),
    (_PTXAS_B6.format(out_st=0, out_ld=4, state_ld=0, fp32_st=0), "spill"),
    (_PTXAS_B6.format(out_st=0, out_ld=0, state_ld=8, fp32_st=0), "spill"),
    (_PTXAS_B6.format(out_st=0, out_ld=0, state_ld=0, fp32_st=0)
     .split("ptxas info    : Function properties for _ZN12_GLOBAL__N_15"
            "ssd_chunk_state")[0], "missing"),
], ids=["clean", "fp32_spill_allowed", "out_stores", "out_loads",
        "state_loads", "state_missing"])
def test_chip_smoke_b6_spill_check(log, error):
    """The smoke script's [build] check: each of B6's three bf16 kernels in
    the ptxas report with no spill; the fp32 SIMT kernel may spill."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    if error is None:
        chip_smoke.check_b6_spills(log)
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke.check_b6_spills(log)


def test_ssd_precision_probe_on_cpu(capsys):
    """The rounding probe (``repro_torch.launch.ssd_precision``) at the
    smoke size on the CPU, where the kernel path is the plain version: the
    two paths agree exactly, in bf16 and in fp32, and one-ulp flips of
    the plain path's scan outputs move its logits."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import ssd_precision

    real, launches = ssd_ops.ssd_scan, ssd_ops.ssd_scan.launches
    ssd_precision.main(["--smoke", "--device", "cpu", "--prompt-len", "40",
                        "--rates", "0.1"])
    assert ssd_ops.ssd_scan is real and real.launches == launches
    out = capsys.readouterr().out
    assert "bf16 kernel path from the bf16 plain path: 0.000e+00" in out
    assert "fp32 kernel path from the fp32 plain path: 0.000e+00" in out
    assert "differing from the plain version's in bf16: 0 of " in out
    moved = [line for line in out.splitlines() if "moved by one" in line]
    assert len(moved) == 1 and float(moved[0].rsplit(" ", 1)[1]) > 0
    own = [line for line in out.splitlines() if "own bf16" in line]
    assert len(own) == 1 and float(own[0].split(": ")[1].split(",")[0]) > 0
