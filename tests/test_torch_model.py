"""The port's decoder against the JAX package's, on carried weights.

JAX initialises the parameters; ``repro_torch.convert`` carries them over
(through numpy); both packages then run ``prefill`` and ``decode_step``s
on the smoke configs of qwen1.5 (QKV bias), smollm (GQA), mistral-large
(GQA, rope theta 1e6), mamba2 (the ssm family: 3 SSD layers, chunk 8) and
recurrentgemma (the hybrid family: RG-LRU, RG-LRU, local attention over a
window of 8, then two more RG-LRU layers).  The dense models are also
prefilled padded (``true_len``); a recurrent model never is, since
padding would corrupt its terminal state.  In float32 the logits agree within 1e-4 —
the two frameworks sum in different orders, so the agreement is to
rounding, not bitwise.  A bf16 round trip checks that ``convert`` moves
bfloat16 bits unchanged.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.convert import convert_params, to_tensor  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

DENSE = ("qwen1.5-0.5b", "smollm-360m", "mistral-large-123b")
ARCHS = DENSE + ("mamba2-370m", "recurrentgemma-9b")
FP32 = dict(dtype="float32", param_dtype="float32")


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw)
    tc = dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw)
    return jc, tc


def _jprefill(jp, toks, jc, max_len=None, true_len=None):
    f = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t}, jc,
                                           max_len=max_len, true_len=n))
    return f(jp, jnp.asarray(toks, jnp.int32),
             None if true_len is None else jnp.asarray(true_len))


def _jdecode(jc):
    return jax.jit(lambda p, c, t: jm.decode_step(p, c, t, jc))


def _carry(jc, tc, seed=0):
    jp = jm.init_params(jc, jax.random.PRNGKey(seed))
    return jp, convert_params(jax.tree.map(np.asarray, jp), tc)


@pytest.mark.parametrize("arch", ARCHS + ("tinyllama-1.1b",))
def test_param_count_on_meta_matches_reference(arch):
    """Full width: the port's ``init_params`` on the meta device (shapes,
    no data) has the JAX package's leaves, counted from its abstract init
    (``jax.eval_shape``, nothing computed)."""
    jc = jconfigs.get_config(arch)
    tc = tconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jm.init_params(jc, k),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    got = tt.init_params(tc, device="meta")
    leaves = []
    stack = [got]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        else:
            leaves.append(node)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == want


@pytest.mark.parametrize("arch", ARCHS + ("tinyllama-1.1b",))
def test_configs_match_reference(arch):
    """The port's configs are the JAX package's minus the JAX-only fields."""
    for smoke in (False, True):
        j = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
        t = dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
        for dropped in ("use_pallas", "remat", "scan_layers"):
            j.pop(dropped)
        assert t == j


def test_unported_families_refuse():
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tconfigs.get_config("mixtral-8x22b")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tconfigs.get_config("whisper-medium")
    cfg = dataclasses.replace(tconfigs.get_config("qwen1.5-0.5b", smoke=True),
                              family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.block_pattern(cfg)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_match_reference(arch, padded):
    _check_prefill_and_decode(arch, padded)


def test_ssm_prefill_and_decode_match_reference():
    """mamba2: the terminal ``ssm``/``conv`` states and ``pos`` after
    prefill, then 8 decode steps.  Unpadded only: a recurrent model's
    terminal state would take in the padding (``supports_padded_prefill``
    is False for it)."""
    assert not tt.supports_padded_prefill(
        tconfigs.get_config("mamba2-370m", smoke=True), 16, 24)
    _check_prefill_and_decode("mamba2-370m", padded=False)


@pytest.mark.parametrize("S", [5, 12])
def test_hybrid_prefill_and_decode_match_reference(S):
    """recurrentgemma: the RG-LRU ``h``/``conv`` states and the local
    attention's K/V ring after prefill, then 8 decode steps; a 12-token
    prompt is longer than the window of 8, so prefill keeps only its last
    8 positions and decode wraps the ring.  Unpadded only, as mamba2."""
    assert not tt.supports_padded_prefill(
        tconfigs.get_config("recurrentgemma-9b", smoke=True), 16, 24)
    _check_prefill_and_decode("recurrentgemma-9b", padded=False, S=S)


def _jax_layer_caches(jcache, jc):
    """The JAX caches per layer in forward order: unit ``u``'s block ``j``
    (stacked, n_units first), then the remainder blocks."""
    n_units = jc.num_layers // len(jc.block_pattern or (None,))
    out = [{k: np.asarray(v)[u] for k, v in unit.items()}
           for u in range(n_units) for unit in jcache["units"]]
    return out + [{k: np.asarray(v) for k, v in b.items()}
                  for b in jcache["rem"]]


def _check_prefill_and_decode(arch, padded, S=None):
    jc, tc = _cfgs(arch, **FP32)
    jp, tp = _carry(jc, tc)
    rng = np.random.RandomState(1)
    ssm = jc.family == "ssm"
    hybrid = jc.family == "hybrid"
    # an SSD prompt keeps the chunk rule (8 divides 16); 8 decode steps
    B, max_len = 2, 24 if ssm or hybrid else 20
    S = S or (16 if ssm else 12)
    n_real, steps = np.array([S, 7]), 8 if ssm or hybrid else 4
    toks = rng.randint(1, jc.vocab_size, (B, S)).astype(np.int32)
    tl = n_real if padded else None

    jl, jcache = _jprefill(jp, toks, jc, max_len=max_len, true_len=tl)
    tl_t = None if tl is None else torch.as_tensor(tl)
    tlog, tcache = tt.prefill(tp, {"tokens": torch.as_tensor(toks).long()}, tc,
                              max_len=max_len, true_len=tl_t)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    # the caches the decode will read, layer by layer; the JAX package
    # stacks layers first: (n_layers, B, ...)
    if hybrid:
        jlayers = _jax_layer_caches(jcache, jc)
        for (kind, slot), want in zip(tt.layer_slots(tc), jlayers):
            for key in want:
                np.testing.assert_allclose(
                    tcache[key][:, slot].numpy(), want[key], atol=1e-5,
                    rtol=1e-5, err_msg=f"{kind} slot {slot} {key}")
    for key in () if hybrid else ("ssm", "conv") if ssm else ("k",):
        want = np.asarray(jcache["units"][0][key])
        got = tcache[key].numpy()
        np.testing.assert_allclose(np.moveaxis(got, 1, 0), want, atol=1e-5,
                                   rtol=1e-4 if key == "ssm" else 1e-5)

    nxt = rng.randint(1, jc.vocab_size, (steps, B)).astype(np.int32)
    jstep = _jdecode(jc)
    for t in range(steps):
        jl, jcache = jstep(jp, jcache, jnp.asarray(nxt[t]))
        tlog, tcache = tt.decode_step(tp, tcache,
                                      torch.as_tensor(nxt[t]).long(), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_decode_wraps_ring_like_reference():
    """max_len shorter than prompt + decode: the ring wraps and slot
    positions come from floor-mod (transformer.py:762)."""
    jc, tc = _cfgs("smollm-360m", **FP32)
    jp, tp = _carry(jc, tc, seed=3)
    toks = np.random.RandomState(2).randint(1, jc.vocab_size, (1, 6))
    jl, jcache = _jprefill(jp, toks, jc, max_len=7)
    tlog, tcache = tt.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc,
                              max_len=7)
    jstep = _jdecode(jc)
    for t in range(4):
        tok = np.array([int(np.argmax(np.asarray(jl)[0, 0]))], np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tt.decode_step(tp, tcache, torch.as_tensor(tok).long(),
                                      tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)


def test_ring_positions_floor_mod():
    """Slot positions floor like jnp's %, never truncate like fmod."""
    pos = np.array([0, 3, 9, 15], np.int64)
    L = 8
    s = np.arange(L)
    want = np.asarray(
        jnp.asarray(pos)[:, None]
        - ((jnp.asarray(pos)[:, None] - jnp.asarray(s)[None, :]) % L)
    )
    got = tt._ring_positions(torch.as_tensor(pos), L).numpy()
    np.testing.assert_array_equal(got, want)
    trunc = pos[:, None] - np.fmod(pos[:, None] - s[None, :], L)
    assert (got != trunc).any()  # the trap is real at these positions


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_round_trip_through_convert(arch):
    jc, tc = _cfgs(arch)  # bf16 weights, the configs' own dtypes
    jp, tp = _carry(jc, tc)
    jn = jax.tree.map(np.asarray, jp)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    emb = tp["embed"].view(torch.int16).numpy()
    np.testing.assert_array_equal(emb, jn["embed"].view(np.int16))
    bits = lambda t: t.view(torch.int16).numpy()
    if jc.family == "hybrid":  # layer 1: RG-LRU; layer 2: local attention
        blk, jblk = tp["layers"][1], jn["units"][1]
        np.testing.assert_array_equal(  # dense: transposed
            bits(blk["rec_proj"]["w"]),
            jblk["rec_proj"]["w"][0].T.view(np.int16))
        np.testing.assert_array_equal(  # conv (K, w): as it is
            bits(blk["conv_w"]), jblk["conv_w"][0].view(np.int16))
        for name in ("lam", "w_a", "b_a", "w_x", "b_x"):  # fp32 vectors
            assert blk["lru"][name].dtype == torch.float32
            np.testing.assert_array_equal(blk["lru"][name].numpy(),
                                          jblk["lru"][name][0])
        np.testing.assert_array_equal(
            bits(tp["layers"][2]["attn"]["wk"]["w"]),
            jn["units"][2]["attn"]["wk"]["w"][0].T.view(np.int16))
        np.testing.assert_array_equal(  # the remainder: the last layer
            bits(tp["layers"][-1]["mlp"]["wo"]["w"]),
            jn["rem"][-1]["mlp"]["wo"]["w"].T.view(np.int16))
    elif jc.family == "ssm":
        blk, jblk = tp["layers"][1], jn["units"][0]
        np.testing.assert_array_equal(  # dense: transposed
            bits(blk["in_proj"]["w"]),
            jblk["in_proj"]["w"][1].T.view(np.int16))
        np.testing.assert_array_equal(  # conv (K, channels): as it is
            bits(blk["conv_w"]), jblk["conv_w"][1].view(np.int16))
        for name in ("A_log", "dt_bias", "D", "norm", "out_norm"):
            np.testing.assert_array_equal(blk[name].numpy(),
                                          jblk[name][1])
    else:
        wq = tp["layers"][1]["attn"]["wq"]
        np.testing.assert_array_equal(
            bits(wq["w"]),
            jn["units"][0]["attn"]["wq"]["w"][1].T.view(np.int16),
        )
        assert ("b" in wq) == jc.qkv_bias
    np.testing.assert_array_equal(
        tp["lm_head"]["w"].float().numpy(),
        np.asarray(jn["lm_head"]["w"], np.float32).T,
    )
    bits = np.array([1.5, -2.25, 3e38], np.float32).astype(jnp.bfloat16)
    assert to_tensor(bits).tolist() == [1.5, -2.25, float(bits[2])]


def test_bf16_prefill_close_to_reference():
    """The configs' own bf16 dtypes: the port's prefill logits stay within
    bf16 rounding of the JAX package's (the two round at other places)."""
    jc, tc = _cfgs("qwen1.5-0.5b")
    jp, tp = _carry(jc, tc)
    toks = np.random.RandomState(4).randint(1, jc.vocab_size, (1, 10))
    jl, _ = _jprefill(jp, toks, jc)
    tlog, _ = tt.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc)
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jl, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_init_params_shapes_and_generator():
    tc = tconfigs.get_config("qwen1.5-0.5b", smoke=True)
    g = torch.Generator().manual_seed(5)
    p = tt.init_params(tc, g, device="cpu")
    p2 = tt.init_params(tc, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(p["embed"], p2["embed"])
    assert len(p["layers"]) == tc.num_layers
    a = p["layers"][0]["attn"]
    assert a["wq"]["w"].shape == (tc.q_dim, tc.d_model)
    assert a["wq"]["b"].shape == (tc.q_dim,)
    assert p["layers"][0]["mlp"]["wo"]["w"].shape == (tc.d_model, tc.d_ff)
    assert p["lm_head"]["w"].shape == (tc.vocab_size, tc.d_model)
    assert p["embed"].dtype == torch.bfloat16
    assert float(p["embed"].float().abs().max()) <= 0.04 + 1e-3


@pytest.mark.parametrize("n_prompt", [1, 2, 4])  # up to 8 = ssm_chunk
def test_ssm_prefill_then_decode_equals_longer_prefill(n_prompt):
    """A prompt of n tokens followed by decode steps gives the logits and
    states of prefilling the longer prompts: the terminal ``ssm`` state
    and the ``conv`` window (zero rows in front when n < K-1, the window
    of a zero history) continue the recurrence exactly."""
    tc = dataclasses.replace(tconfigs.get_config("mamba2-370m", smoke=True),
                             **FP32)
    tp = tt.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.as_tensor(np.random.RandomState(5).randint(
        1, tc.vocab_size, (2, n_prompt + 4)))
    logits, caches = tt.prefill(tp, {"tokens": toks[:, :n_prompt]}, tc)
    for t in range(n_prompt, n_prompt + 4):
        logits, caches = tt.decode_step(tp, caches, toks[:, t], tc)
        want, wcache = tt.prefill(tp, {"tokens": toks[:, :t + 1]}, tc)
        torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(caches["ssm"], wcache["ssm"], atol=1e-5,
                                   rtol=1e-4)
        torch.testing.assert_close(caches["conv"], wcache["conv"])
        assert torch.equal(caches["pos"], wcache["pos"])


@pytest.mark.parametrize("n_prompt", [1, 2, 9])  # 9 > local_window = 8
def test_hybrid_prefill_then_decode_equals_longer_prefill(n_prompt):
    """recurrentgemma: a prompt of n tokens followed by decode steps gives
    the logits and caches of prefilling the longer prompts.  The RG-LRU
    ``conv`` window keeps zero rows in front when n < K-1 (the port's
    rule, ROADMAP C4) and the K/V ring wraps past the window."""
    tc = dataclasses.replace(
        tconfigs.get_config("recurrentgemma-9b", smoke=True), **FP32)
    tp = tt.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.as_tensor(np.random.RandomState(6).randint(
        1, tc.vocab_size, (2, n_prompt + 4)))
    logits, caches = tt.prefill(tp, {"tokens": toks[:, :n_prompt]}, tc,
                                max_len=32)
    for t in range(n_prompt, n_prompt + 4):
        logits, caches = tt.decode_step(tp, caches, toks[:, t], tc)
        want, wcache = tt.prefill(tp, {"tokens": toks[:, :t + 1]}, tc,
                                  max_len=32)
        torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
        for key in ("h", "conv", "k", "v"):
            torch.testing.assert_close(caches[key], wcache[key], atol=1e-5,
                                       rtol=1e-4)
        assert torch.equal(caches["pos"], wcache["pos"])


def test_hybrid_cache_layout():
    """recurrentgemma-9b at full width: 26 RG-LRU slots and 12 attention
    slots over a ring of the window, layer 3u + j in unit order."""
    cfg = tconfigs.get_config("recurrentgemma-9b")
    slots = tt.layer_slots(cfg)
    assert slots[:6] == [("rglru", 0), ("rglru", 1), ("attn_local", 0),
                         ("rglru", 2), ("rglru", 3), ("attn_local", 1)]
    assert slots[-2:] == [("rglru", 24), ("rglru", 25)]
    caches = tt.init_decode_caches(cfg, 2, 3072, "meta")
    assert tuple(caches["k"].shape) == (2, 12, 2048, 1, 256)
    assert tuple(caches["h"].shape) == (2, 26, 4096)
    assert caches["h"].dtype == torch.float32
    assert tuple(caches["conv"].shape) == (2, 26, 3, 4096)
    assert caches["conv"].dtype == torch.bfloat16
    short = tt.init_decode_caches(cfg, 1, 1024, "meta")
    assert short["k"].shape[2] == 1024  # min(window, max_len)
