"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Builds random weights for the selected config from a seeded
``torch.Generator``, starts the continuous-batching engine, feeds it a
synthetic request stream with mixed prompt lengths and reports decode
throughput and prefill time.  Runs on CUDA by default (``--device cpu``
is for tests); on CUDA the prefill attention is the flash kernel and the
SSD and RG-LRU scans their kernels.

* A warmup round (one request per prompt length the stream uses) runs
  before the timed region, so the kernel build and first-call setup are
  excluded from the rates.
* tok/s counts decode tokens only; prefill seconds are reported apart.
* If the engine truncates at ``max_steps`` the launcher says so and
  exits non-zero.
"""
from __future__ import annotations

import argparse
import sys
import time
import warnings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots per replica")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--shards", type=int, default=1,
                    help="serve ranks per replica (slot pool sharding)")
    ap.add_argument("--max-steps", type=int, default=10_000)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         num_slots=args.slots, num_replicas=args.replicas,
                         replica_shards=args.shards, device=device)
    rng = np.random.RandomState(args.seed)

    def make(i, plen):
        plen = max(1, min(plen, args.max_len - args.max_new_tokens))
        return Request(rid=i,
                       prompt=rng.randint(1, cfg.vocab_size,
                                          (plen,)).astype(np.int32),
                       max_new_tokens=args.max_new_tokens)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    lens = [max(1, args.prompt_len // 2), args.prompt_len]
    for j, plen in enumerate(dict.fromkeys(lens)):
        engine.submit(make(-1 - j, plen))
    engine.run_to_completion(max_steps=args.max_steps)
    sync()
    engine.reset_stats()

    reqs = [make(i, lens[i % len(lens)]) for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = engine.run_to_completion(max_steps=args.max_steps)
    sync()
    dt = time.perf_counter() - t0

    decode_tokens = engine.counters["decode_tokens"]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} device={where} replicas={args.replicas} "
          f"shards={args.shards} slots={args.slots}: served "
          f"{len(done)}/{len(reqs)} requests in {dt:.3f}s over "
          f"{engine.counters['steps']} engine steps")
    print(f"  decode: {decode_tokens} tokens -> {decode_tokens / dt:.1f} "
          f"tok/s (prefill echo: {engine.counters['prefill_tokens']} "
          "tokens, excluded)")
    print("  phase seconds: " + ", ".join(
        f"{k}={v:.4f}" for k, v in engine.phase_seconds.items()))
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")
    if engine.truncated:
        msgs = "; ".join(str(w.message) for w in caught
                         if issubclass(w.category, RuntimeWarning))
        print(f"TRUNCATED: {msgs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
