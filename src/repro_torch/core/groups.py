"""Process groups: the static ``comm.split`` machinery (DESIGN.md §9).

Ported as far as ``Communicator.split_by(block=...)`` needs it: a static,
uniform partition of the axis ranks and its per-rank lookup tables.  The
grouped collectives themselves live in the native transport, which
gathers each group's rows from the stacked rank dimension with these
tables.  See the JAX package's ``core/groups.py`` for the full contract.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .errors import KampingError

__all__ = ["Groups", "GroupTables", "validate_groups", "split_groups"]

# A partition of the global axis ranks: tuple of equally-sized tuples of
# global rank indices, in group-rank order.
Groups = Tuple[Tuple[int, ...], ...]


def validate_groups(groups, world: int) -> Groups:
    """Canonicalize and check a group structure against the axis size.

    Groups must partition ``range(world)`` into disjoint, covering,
    equally-sized tuples (the SPMD uniformity rule).
    """
    canon: List[Tuple[int, ...]] = []
    seen: set = set()
    for g in groups:
        members = tuple(int(r) for r in g)
        if not members:
            raise KampingError("comm.split: empty group in group structure")
        for r in members:
            if r < 0 or r >= world:
                raise KampingError(
                    f"comm.split: group member {r} outside the axis "
                    f"(world size {world})"
                )
            if r in seen:
                raise KampingError(
                    f"comm.split: rank {r} appears in more than one group"
                )
            seen.add(r)
        canon.append(members)
    if len(seen) != world:
        missing = sorted(set(range(world)) - seen)
        raise KampingError(
            f"comm.split: groups must cover every rank of the axis; "
            f"missing {missing}"
        )
    sizes = {len(g) for g in canon}
    if len(sizes) != 1:
        raise KampingError(
            f"comm.split: all groups must have the same size under SPMD "
            f"(per-rank result shapes are static); got sizes "
            f"{sorted(len(g) for g in canon)}"
        )
    return tuple(canon)


def _normalize_assignment(name: str, value, size: int) -> List[int]:
    """colors/keys: a per-member sequence or a rank->value callable,
    resolved to a static Python list of ints before launch."""
    if isinstance(value, torch.Tensor):
        raise KampingError(
            f"comm.split: tensor {name} — group membership must be static "
            f"(the paper's zero-overhead rule, DESIGN.md §9). Pass a "
            f"Python/NumPy sequence or a rank->{name[:-1]} callable."
        )
    if callable(value):
        value = [value(r) for r in range(size)]
    vals = list(value)
    if len(vals) != size:
        raise KampingError(
            f"comm.split: {name} must have one entry per rank of this "
            f"communicator (size {size}); got {len(vals)}"
        )
    return [int(v) for v in vals]


def split_groups(parent: Optional[Groups], world: int, colors,
                 keys=None) -> Groups:
    """Split a (possibly already split) communicator by color and key.

    Members of a new group are ordered by ``(key, parent rank)``
    (MPI_Comm_split's stable-sort contract); splits compose.
    """
    if parent is None:
        parent = (tuple(range(world)),)
    else:
        parent = validate_groups(parent, world)
    size = len(parent[0])
    colors = _normalize_assignment("colors", colors, size)
    keys = (
        list(range(size))
        if keys is None
        else _normalize_assignment("keys", keys, size)
    )
    out: List[Tuple[int, ...]] = []
    for grp in parent:
        by_color: dict = {}
        for i, member in enumerate(grp):
            by_color.setdefault(colors[i], []).append((keys[i], i, member))
        for color in sorted(by_color):
            ordered = sorted(by_color[color])
            out.append(tuple(m for _, _, m in ordered))
    return validate_groups(out, world)


class GroupTables:
    """Static per-rank lookup tables of a group structure:
    ``group_rank[r]`` and ``members[r]`` (the member list of global rank
    ``r``'s group, in group-rank order)."""

    def __init__(self, groups: Groups, world: int):
        groups = validate_groups(groups, world)
        self.groups = groups
        self.world = world
        self.group_size = len(groups[0])
        self.group_rank = np.zeros((world,), np.int64)
        self.members = np.zeros((world, self.group_size), np.int64)
        for grp in groups:
            for i, r in enumerate(grp):
                self.group_rank[r] = i
                self.members[r] = grp
