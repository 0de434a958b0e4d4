"""Explicit serialization (paper §III-D3).

KaMPIng refuses to serialize implicitly — hidden (de)serialization means
hidden allocation and compute.  ``as_serialized(tree)`` *explicitly* packs
a flat list or dict of tensors into one contiguous ``uint8`` buffer
(flatten + byte view + concat) carrying a static spec, so it can travel
through a single-buffer collective (``bcast``, ``send_recv``);
``deserialize`` reverses it.

The "archive" is a flat byte tensor, the "type registry" the container's
keys and each leaf's (shape, dtype) — all static, so pack and unpack are
byte views and one concatenation, with no host round trip.

For *host-side* objects (configs, checkpoint metadata) there is a pickle
archive, used only outside ``spmd``.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["as_serialized", "Serialized", "as_deserializable",
           "deserialize_like", "deserialize", "host_pack", "host_unpack"]


@dataclasses.dataclass
class Serialized:
    """A flat list or dict of tensors packed into one uint8 buffer + its
    static spec."""

    buffer: Any  # uint8[total_bytes]
    keys: Optional[Tuple]  # dict keys in order; None for a list
    leaf_specs: List[Tuple[Tuple[int, ...], torch.dtype]]

    @property
    def nbytes(self) -> int:
        return self.buffer.shape[0]


def _leaves(tree):
    if isinstance(tree, dict):
        return tuple(tree), list(tree.values())
    if isinstance(tree, (list, tuple)):
        return None, list(tree)
    raise TypeError(
        f"as_serialized: expected a flat list or dict of tensors, got "
        f"{type(tree).__name__}"
    )


def _leaf_bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def as_serialized(tree) -> Serialized:
    """Explicitly pack a flat list or dict of tensors into a byte buffer
    (Fig. 5/11)."""
    keys, leaves = _leaves(tree)
    specs, chunks = [], []
    for leaf in leaves:
        if isinstance(leaf, (list, dict)):
            raise TypeError("as_serialized: nested containers are not "
                            "supported; pass a flat list or dict")
        leaf = torch.as_tensor(leaf)
        specs.append((tuple(leaf.shape), leaf.dtype))
        flat = leaf.reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        chunks.append(flat.contiguous().view(torch.uint8))
    buffer = torch.cat(chunks) if chunks else torch.zeros((0,), torch.uint8)
    return Serialized(buffer, keys, specs)


def as_deserializable(tree_like) -> Serialized:
    """Receive-side spec: a Serialized with a zero buffer of the right
    size, describing what to reconstruct (cf. ``as_deserializable<dict>()``)."""
    keys, leaves = _leaves(tree_like)
    zeros = [torch.zeros_like(torch.as_tensor(v)) for v in leaves]
    return as_serialized(dict(zip(keys, zeros)) if keys is not None
                         else zeros)


def deserialize_like(spec: Serialized, buffer) -> Any:
    """Unpack a byte buffer using a Serialized's static spec."""
    leaves, off = [], 0
    for shape, dtype in spec.leaf_specs:
        nb = _leaf_bytes(shape, dtype)
        # a fresh copy: a byte view as a wider type needs aligned storage
        chunk = buffer[off: off + nb].clone()
        if dtype == torch.bool:
            leaf = chunk.to(torch.bool)
        else:
            leaf = chunk.view(dtype)
        leaves.append(leaf.reshape(shape))
        off += nb
    if spec.keys is None:
        return leaves
    return dict(zip(spec.keys, leaves))


def deserialize(s: Serialized) -> Any:
    return deserialize_like(s, s.buffer)


# -- host-side archive (outside spmd only) ------------------------------------
def host_pack(obj) -> torch.Tensor:
    """Pickle archive for host metadata (checkpoint manifests, configs)."""
    return torch.from_numpy(
        np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy())


def host_unpack(buf) -> Any:
    """Unpack a :func:`host_pack` archive.  Unpickling runs code: only
    unpack bytes this program wrote."""
    return pickle.loads(torch.as_tensor(buf, dtype=torch.uint8).cpu()
                        .numpy().tobytes())
