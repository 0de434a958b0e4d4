"""How far mamba2-370m's bf16 prefill logits move with the SSD scan's
rounding: ``python -m repro_torch.launch.ssd_precision`` (on the CUDA
card by default, where it builds the SSD kernel at first use;
``--smoke --device cpu`` runs the small config on the CPU, where both
paths are the plain version).

Full-width (or ``--smoke``) mamba2-370m with random weights from
``--seed`` prefills one prompt of ``--prompt-len`` random tokens.  Every
distance printed is the relative L2 distance of the last token's logits:

* the bf16 kernel path from the bf16 plain path (the distance that
  ``chip_smoke.py`` ``[serve-ssm]`` holds under 2%), and the share of the
  scan's bf16 outputs, over every layer, that differ from the plain
  version's on the same inputs;
* the bf16 plain path with a share (``--rates``) of its scan outputs,
  chosen at random, moved by one bf16 ulp, from the bf16 plain path:
  how many such flips a given distance stands for;
* the bf16 plain and kernel paths from the same weights evaluated in fp32
  through the plain path: the model's own bf16 distance, against which
  the 2% limit can be judged;
* the fp32 kernel path from the fp32 plain path.

It checks nothing; ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses


@contextlib.contextmanager
def _scan_replaced(ssd_ops, scan):
    """The models' SSD scan replaced by ``scan``, then restored.  The
    wrapper counts its launches on the module's ``ssd_scan``, so ``scan``
    carries the count while it stands in."""
    real = ssd_ops.ssd_scan
    scan.launches = real.launches
    ssd_ops.ssd_scan = scan
    try:
        yield
    finally:
        real.launches = scan.launches
        ssd_ops.ssd_scan = real


def _to_fp32_in_place(tree):
    """Every tensor of a parameter tree in fp32, leaf by leaf, so the bf16
    and fp32 copies of the whole model are never both held."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            _to_fp32_in_place(leaf)
        else:
            tree[key] = leaf.float()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[1e-5, 1e-4, 1e-3])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import init_params, prefill

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mamba2-370m", smoke=args.smoke)
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(args.seed), device=device)
    rng = np.random.RandomState(args.seed)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size,
                                       (1, args.prompt_len)), device=device)
    real = ssd_ops.ssd_scan

    def logits(config, force_ref=False):
        out, _ = prefill(params, {"tokens": toks}, config,
                         force_ref=force_ref)
        return out.float()

    def rel(x, y):
        return float((x - y).norm() / y.norm())

    print(f"mamba2-370m {'smoke' if args.smoke else 'full width'} on "
          f"{device}, seed {args.seed}, prompt "
          f"{args.prompt_len} tokens, {cfg.num_layers} SSD layers; "
          "last-token prefill logits, rel L2")
    got, want = logits(cfg), logits(cfg, force_ref=True)
    print(f"  bf16 kernel path from the bf16 plain path: {rel(got, want):.3e}"
          f", same argmax {bool(got.argmax() == want.argmax())}")

    diff = [0, 0]

    def both(x, a, Bm, C, *, chunk, force_ref=False):
        out = real(x, a, Bm, C, chunk=chunk)
        plain = real(x, a, Bm, C, chunk=chunk, force_ref=True)
        diff[0] += int((out != plain).sum())
        diff[1] += out.numel()
        return out

    with _scan_replaced(ssd_ops, both):
        logits(cfg)
    print(f"  scan outputs differing from the plain version's in bf16: "
          f"{diff[0]} of {diff[1]} ({diff[0] / diff[1]:.3e})")

    for rate in args.rates:
        gen = torch.Generator(device=device).manual_seed(args.seed + 7)

        def flipped(x, a, Bm, C, *, chunk, force_ref=False):
            y = real(x, a, Bm, C, chunk=chunk, force_ref=True)
            pick = torch.rand(y.shape, generator=gen, device=y.device) < rate
            up = torch.rand(y.shape, generator=gen, device=y.device) < 0.5
            step = torch.where(up, 1, -1).to(torch.int16)
            return torch.where(pick, (y.view(torch.int16) + step)
                               .view(torch.bfloat16), y)

        with _scan_replaced(ssd_ops, flipped):
            moved = logits(cfg, force_ref=True)
        print(f"  bf16 plain path with {rate:g} of its scan outputs moved by "
              f"one bf16 ulp, from the bf16 plain path: {rel(moved, want):.3e}")

    _to_fp32_in_place(params)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    got32, want32 = logits(cfg32), logits(cfg32, force_ref=True)
    print(f"  bf16 plain path from the fp32 plain path (the model's own bf16 "
          f"distance): {rel(want, want32):.3e}, same argmax "
          f"{bool(want.argmax() == want32.argmax())}")
    print(f"  bf16 kernel path from the fp32 plain path: "
          f"{rel(got, want32):.3e}")
    print(f"  fp32 kernel path from the fp32 plain path: "
          f"{rel(got32, want32):.3e}")


if __name__ == "__main__":
    main()
