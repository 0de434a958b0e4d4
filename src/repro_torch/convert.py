"""Carry the JAX package's parameters over to the port.

:func:`convert_params` takes the JAX parameter pytree as numpy arrays
(the caller converts with ``jax.tree.map(np.asarray, params)``; the port
never imports JAX) and returns the port's parameter dict
(``repro_torch.models.transformer``):

* the stacked ``units`` leaves (leading ``n_units`` axis, one entry per
  block kind of the pattern) and the unrolled ``rem`` blocks become one
  list of per-layer blocks in forward order;
* ``dense`` weights (a dict with ``"w"``) stored ``(d_in, d_out)`` become
  ``(d_out, d_in)``; every other leaf carries over bit for bit: norms,
  SSD's ``conv_w``/``conv_x``/``conv_b``/``conv_c`` ``(K, channels)``
  and its ``(H,)``/``(d,)`` vectors, ``embed`` and ``final_norm``.

bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; they are reinterpreted bit for bit through
int16.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.transformer import block_pattern

__all__ = ["to_tensor", "convert_params"]


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor with the same bits (bfloat16 included)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _dense(d, device):
    out = {"w": to_tensor(np.asarray(d["w"]).T, device)}
    if "b" in d:
        out["b"] = to_tensor(d["b"], device)
    return out


def _block(b, device):
    """A block's pytree: dense dicts transposed, other leaves as they
    are (the attention/MLP blocks and the SSD blocks alike)."""
    if isinstance(b, dict):
        if "w" in b:
            return _dense(b, device)
        return {k: _block(v, device) for k, v in b.items()}
    return to_tensor(b, device)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def convert_params(jparams, cfg, device="cpu"):
    """JAX parameter pytree (numpy leaves) -> the port's parameters."""
    pattern = block_pattern(cfg)
    n_units = cfg.num_layers // len(pattern)
    layers = []
    for u in range(n_units):
        for j in range(len(pattern)):
            layers.append(_block(_index(jparams["units"][j], u), device))
    for b in jparams["rem"]:
        layers.append(_block(b, device))
    out = {
        "embed": to_tensor(jparams["embed"], device),
        "layers": layers,
        "final_norm": to_tensor(jparams["final_norm"], device),
    }
    if "lm_head" in jparams:
        out["lm_head"] = _dense(jparams["lm_head"], device)
    return out
