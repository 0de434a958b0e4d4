"""The port's serving engine: counterparts of tests/test_serve.py.

Weights are the JAX package's, carried over with ``repro_torch.convert``.
Every engine run must give, token for token, what the port's
single-request greedy decode gives, and the JAX ``ServeEngine`` must give
the same tokens on the same weights.  The engine runs on the CPU here
(``device="cpu"``); on a card its prefill attention is the flash kernel.

The JAX tests' compile-count checks (``prefill_cache_size``) have no
counterpart: PyTorch runs eagerly and compiles nothing per bucket.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.models as jm  # noqa: E402
import repro.serve as js  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.core import KampingError  # noqa: E402
from repro_torch.models import ModelConfig, decode_step, prefill  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

_CFG_ARGS = dict(
    name="s", family="dense", num_layers=2, d_model=32, num_heads=4,
    num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
    param_dtype="float32",
)
CFG = ModelConfig(**_CFG_ARGS)
JCFG = jm.ModelConfig(**_CFG_ARGS)


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return convert_params(jax.tree.map(np.asarray, jparams), CFG)


def _engine(params, **kw):
    return ServeEngine(CFG, params, device="cpu", **kw)


def _greedy_reference(params, prompt, n_new):
    """Single-request greedy decode through the port's model API."""
    prompt = torch.as_tensor(np.asarray(prompt, np.int64))[None]
    logits, caches = prefill(params, {"tokens": prompt}, CFG,
                             max_len=prompt.shape[1] + n_new)
    out = [int(logits[0, 0].argmax())]
    for _ in range(n_new - 1):
        logits, caches = decode_step(params, caches,
                                     torch.tensor([out[-1]]), CFG)
        out.append(int(logits[0, 0].argmax()))
    return out


def _mixed_requests(rng, specs):
    return [
        Request(prompt=rng.randint(1, CFG.vocab_size, (n,)).astype(np.int32),
                max_new_tokens=m)
        for n, m in specs
    ]


def test_engine_matches_single_request_and_jax_engine(params, jparams):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 64, (6,)).astype(np.int32) for _ in range(3)]
    engine = _engine(params, max_len=16, num_slots=2)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    done = engine.run_to_completion()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert not engine.truncated
    jengine = js.ServeEngine(JCFG, jparams, max_len=16, num_slots=2)
    jreqs = [js.Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jengine.submit(r)
    jengine.run_to_completion()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == 5
        assert r.generated == _greedy_reference(params, r.prompt, 5)
        assert r.generated == jr.generated, (r.rid, r.generated, jr.generated)


def test_mixed_lengths_and_budgets_one_pool(params):
    rng = np.random.RandomState(2)
    specs = [(3, 5), (6, 1), (9, 4), (5, 7), (7, 3), (2, 6)]
    reqs = _mixed_requests(rng, specs)
    engine = _engine(params, max_len=16, num_slots=2)
    for r in reqs:
        engine.submit(r)
    done = engine.run_to_completion()
    assert len(done) == len(reqs) and not engine.truncated
    for r in reqs:
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == _greedy_reference(params, r.prompt,
                                                r.max_new_tokens)


def test_budget_one_finishes_at_admission(params):
    rng = np.random.RandomState(3)
    req = Request(prompt=rng.randint(1, 64, (5,)).astype(np.int32),
                  max_new_tokens=1)
    engine = _engine(params, max_len=16, num_slots=2)
    engine.submit(req)
    done = engine.run_to_completion()
    assert [r.rid for r in done] == [req.rid]
    assert req.generated == _greedy_reference(params, req.prompt, 1)
    assert engine.counters["decode_tokens"] == 0
    assert not engine.active and not engine.slot_live.any()


def test_admission_mid_decode(params):
    rng = np.random.RandomState(4)
    first = Request(prompt=rng.randint(1, 64, (4,)).astype(np.int32),
                    max_new_tokens=8)
    engine = _engine(params, max_len=16, num_slots=2)
    engine.submit(first)
    for _ in range(3):
        engine.step()
    assert engine.slot_live.sum() == 1
    late = Request(prompt=rng.randint(1, 64, (6,)).astype(np.int32),
                   max_new_tokens=4)
    engine.submit(late)
    done = engine.run_to_completion()
    assert sorted(r.rid for r in done) == sorted([first.rid, late.rid])
    assert first.generated == _greedy_reference(params, first.prompt, 8)
    assert late.generated == _greedy_reference(params, late.prompt, 4)


def test_exact_length_fallback_matches(params):
    rng = np.random.RandomState(6)
    reqs = _mixed_requests(rng, [(3, 4), (6, 3)])
    engine = _engine(params, max_len=16, num_slots=2, prompt_buckets=False)
    assert not engine.pad_prompts
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    for r in reqs:
        assert r.generated == _greedy_reference(params, r.prompt,
                                                r.max_new_tokens)


def test_truncation_warns_and_returns_partial(params):
    rng = np.random.RandomState(7)
    engine = _engine(params, max_len=16, num_slots=1)
    for r in _mixed_requests(rng, [(4, 6), (4, 6), (4, 6)]):
        engine.submit(r)
    with pytest.warns(RuntimeWarning, match="max_steps"):
        done = engine.run_to_completion(max_steps=2)
    assert engine.truncated
    assert len(done) < 3 and engine._outstanding()
    rest = engine.run_to_completion()
    assert not engine.truncated
    assert len(done) + len(rest) == 3


@pytest.mark.parametrize("replicas,shards,slots", [
    (1, 1, 2), (2, 1, 2), (2, 2, 2), (4, 1, 1),
])
def test_multi_replica_bitwise(params, replicas, shards, slots):
    rng = np.random.RandomState(8)
    specs = [(3, 5), (6, 1), (9, 4), (5, 7), (7, 3), (4, 6), (8, 2), (2, 5)]
    reqs = _mixed_requests(rng, specs)
    engine = _engine(params, max_len=32, num_slots=slots,
                     num_replicas=replicas, replica_shards=shards)
    for r in reqs:
        engine.submit(r)
    done = engine.run_to_completion()
    assert len(done) == len(reqs) and not engine.truncated
    for r in reqs:
        assert r.generated == _greedy_reference(params, r.prompt,
                                                r.max_new_tokens), r.rid
    stats = engine.last_stats
    assert len(stats["pool_live"]) == replicas
    assert stats["global_live"] == 0


@pytest.mark.parametrize("replicas,shards", [(2, 1), (2, 2)])
def test_replica_liveness_stats(params, replicas, shards):
    """The grouped/global allreduce stats track host-side liveness."""
    rng = np.random.RandomState(9)
    engine = _engine(params, max_len=16, num_slots=shards,
                     num_replicas=replicas, replica_shards=shards)
    engine.submit(Request(prompt=rng.randint(1, 64, (4,)).astype(np.int32),
                          max_new_tokens=6), replica=0)
    engine.submit(Request(prompt=rng.randint(1, 64, (4,)).astype(np.int32),
                          max_new_tokens=2), replica=1)
    engine.step()
    engine.step()
    live = engine.slot_live.reshape(replicas, -1).sum(axis=1)
    assert list(engine.last_stats["pool_live"]) == list(live)
    assert engine.last_stats["global_live"] == int(live.sum())
    engine.run_to_completion()


def test_engine_queue_overflow_handling(params):
    engine = _engine(params, max_len=16, num_slots=1)
    rng = np.random.RandomState(1)
    for i in range(4):
        engine.submit(Request(rid=i,
                              prompt=rng.randint(1, 64, (4,)).astype(np.int32),
                              max_new_tokens=3))
    done = engine.run_to_completion()
    assert not engine.queue and not engine.active
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]


def test_request_validation(params):
    engine = _engine(params, max_len=16, num_slots=2)
    with pytest.raises(KampingError, match="per-slot capacity"):
        engine.submit(Request(prompt=np.arange(1, 30, dtype=np.int32)))
    with pytest.raises(KampingError, match="empty prompt"):
        engine.submit(Request(prompt=np.zeros((0,), np.int32)))
    with pytest.raises(KampingError, match="num_slots"):
        _engine(params, max_len=16, num_slots=3, replica_shards=2)
    with pytest.raises(KampingError, match="greedy"):
        _engine(params, max_len=16, num_slots=2, greedy=False)


@pytest.mark.parametrize("kw,item", [
    (dict(kv_layout="paged"), "A8"),
    (dict(plan="auto"), "A7"),
    (dict(replica_shards="auto"), "A7"),
])
def test_unported_options_refuse(params, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _engine(params, max_len=16, num_slots=2, **kw)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and "device=cpu" in out


# -- the ssm family (mamba2) --------------------------------------------------
@pytest.fixture(scope="module")
def ssm_models():
    """mamba2's smoke config (3 SSD layers, chunk 8) in fp32, JAX weights
    carried over."""
    import dataclasses

    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs

    fp32 = dict(dtype="float32", param_dtype="float32")
    jc = dataclasses.replace(jconfigs.get_config("mamba2-370m", smoke=True),
                             **fp32)
    tc = dataclasses.replace(tconfigs.get_config("mamba2-370m", smoke=True),
                             **fp32)
    jp = jm.init_params(jc, jax.random.PRNGKey(5))
    return jc, tc, jp, convert_params(jax.tree.map(np.asarray, jp), tc)


def test_ssm_engine_matches_jax_engine(ssm_models):
    """Prompts keep the chunk rule (at most 8, or a multiple of 8); the
    recurrent state is spliced and decoded in place, token for token as
    the JAX engine on the same weights."""
    jc, tc, jp, tp = ssm_models
    rng = np.random.RandomState(10)
    specs = [(3, 6), (8, 4), (16, 5), (5, 1), (24, 3), (7, 7)]
    prompts = [rng.randint(1, tc.vocab_size, (n,)).astype(np.int32)
               for n, _ in specs]
    engine = ServeEngine(tc, tp, max_len=32, num_slots=2, device="cpu")
    assert not engine.pad_prompts
    jengine = js.ServeEngine(jc, jp, max_len=32, num_slots=2)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, (_, m)) in enumerate(zip(prompts, specs))]
    jreqs = [js.Request(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, (_, m)) in enumerate(zip(prompts, specs))]
    for r, jr in zip(reqs, jreqs):
        engine.submit(r)
        jengine.submit(jr)
    done = engine.run_to_completion()
    jengine.run_to_completion()
    assert len(done) == len(reqs) and not engine.truncated
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == jr.generated, (r.rid, r.generated,
                                             jr.generated)


def test_ssm_engine_refuses_prompts_that_break_the_chunk_rule(ssm_models):
    _, tc, _, tp = ssm_models
    engine = ServeEngine(tc, tp, max_len=32, num_slots=1, device="cpu")
    with pytest.raises(KampingError, match="chunk rule"):
        engine.submit(Request(prompt=np.arange(1, 13, dtype=np.int32)))
    assert not engine.queue
    engine.submit(Request(prompt=np.arange(1, 17, dtype=np.int32),
                          max_new_tokens=2))
    assert len(engine.run_to_completion()) == 1


def test_launcher_serves_mamba2_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "arch=mamba2-370m-smoke" in out and "served 3/3 requests" in out
