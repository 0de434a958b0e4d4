"""Per-device ranks: the PyTorch counterpart of ``jax.shard_map``.

In the JAX package a ``Communicator`` usually runs inside
``jax.shard_map`` over a one-axis mesh: one controller, ``p`` devices,
each running its own program on its own local shard.  The port's
:func:`~repro_torch.core.spmd.spmd` emulates ranks as slices of one
stacked tensor instead.  :func:`shard_map` gives the port the per-device
model: every rank is a device context in this process, with its own
thread, its own CUDA stream and its own allocations, and a collective is
a meeting of the ``p`` rank threads.

* The rank threads meet at a host rendezvous (:meth:`Rank.exchange`).  On
  CUDA a rank posts its tensor with an event recorded on its stream, and a
  rank that reads another's tensor first makes its own stream wait on that
  event (:meth:`Rank.share`), so reads follow the owner's writes on the
  card without any host synchronisation.
* All ranks share one card.  Kernels on streams of one context run at the
  same time, so the per-device ring kernels (B8) can wait on each other
  inside the kernel.  Placing ranks on several cards is not part of this
  mode yet (ROADMAP A13).
* A rank that raises, or a rendezvous that is not complete within
  ``timeout`` seconds, ends the call for every rank and raises in the
  caller; so does a device ring kernel whose spin ran out (its status
  word, read when the ranks' streams are synchronised).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from .errors import KampingError
from .spmd import bind_rank

__all__ = ["shard_map", "Rank", "RankGroup"]


class _Abandoned(KampingError):
    """A rendezvous broken by another rank's failure or its timeout."""

_STREAMS: Dict[tuple, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()


def _rank_stream(device: torch.device, rank: int):
    """The stream of rank ``rank`` on ``device``, made once per process:
    the caching allocator keeps freed blocks per stream, so new streams
    on every call would strand the memory of the old ones.  PyTorch hands
    out its pooled (non-blocking) streams round robin, so a stream already
    given to another rank is skipped: two ranks on one stream would wait
    for each other's ring kernel forever."""
    key = (device.index, rank)
    with _STREAMS_LOCK:
        stream = _STREAMS.get(key)
        if stream is None:
            used = {s.cuda_stream for (d, _), s in _STREAMS.items()
                    if d == device.index}
            for _ in range(64):
                stream = torch.cuda.Stream(device=device)
                if stream.cuda_stream not in used:
                    break
            else:
                raise KampingError(
                    f"shard_map: no free CUDA stream for rank {rank}; "
                    f"{len(used)} ranks already have one")
            _STREAMS[key] = stream
    return stream


class RankGroup:
    """What the ``p`` ranks of one :func:`shard_map` call share: the host
    rendezvous, their streams and, on CUDA, the semaphore area of the
    device ring kernels (one row of ``sem_words`` 32-bit words per rank,
    zeroed once here; every kernel call carries a fresh epoch, so nothing
    is zeroed again)."""

    def __init__(self, p: int, device: torch.device, timeout: float):
        self.size = p
        self.device = device
        self.timeout = timeout
        self._barrier = threading.Barrier(p, timeout=timeout)
        self._slots = ([None] * p, [None] * p)
        self.streams: List[Optional[torch.cuda.Stream]] = [None] * p
        self.sems = None
        self.blocks = 0
        if device.type == "cuda":
            self.streams = [_rank_stream(device, r) for r in range(p)]
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            # co-residency: the p ring kernels together use at most one
            # block per SM (csrc/device_ring.cu)
            self.blocks = max(1, sms // p)
            self.sems = torch.zeros((p, sem_words(p, self.blocks)),
                                    dtype=torch.int32, device=device)

    def meet(self):
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise _Abandoned(
                f"shard_map: a rank failed or did not reach the rendezvous "
                f"within {self.timeout} s") from None

    def abort(self):
        self._barrier.abort()


def sem_words(p: int, blocks: int) -> int:
    """Words of one rank's semaphore area (layout in csrc/device_ring.cu):
    two barrier flags, then an arrival and a credit counter for each
    (ring step, block), then the status word."""
    return 2 * blocks + 2 * max(p - 1, 1) * blocks + 1


class Rank:
    """One rank's side of a :class:`RankGroup`: its index, its stream, and
    the rendezvous the collectives and the device ring kernels use."""

    def __init__(self, group: RankGroup, rank: int):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.device
        self.blocks = group.blocks  # block cap of a device ring kernel
        self.stream = group.streams[rank]
        self._calls = 0  # rendezvous so far: picks the slot buffer
        self._epoch = 0  # device ring kernel calls so far

    def exchange(self, obj) -> list:
        """Post ``obj``, wait for every rank, return every rank's post.
        Two slot buffers alternate: a rank can post call k+1 while a slow
        rank still reads call k, but not call k+2 before it passed k+1."""
        slots = self.group._slots[self._calls % 2]
        self._calls += 1
        slots[self.rank] = obj
        self.group.meet()
        return list(slots)

    def share(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, safe to read on this rank's stream."""
        if self.stream is None:
            return self.exchange(t)
        event = torch.cuda.Event()
        event.record(self.stream)
        posts = self.exchange((t, event))
        for _, e in posts:
            self.stream.wait_event(e)
        return [u for u, _ in posts]

    def barrier(self):
        """Every rank's stream has reached this point before this rank's
        stream goes on; the host threads meet too."""
        if self.stream is None:
            self.exchange(None)
            return
        event = torch.cuda.Event()
        event.record(self.stream)
        for e in self.exchange(event):
            self.stream.wait_event(e)

    def next_epoch(self) -> int:
        """The epoch of the next device ring kernel call: every rank calls
        the kernels in the same order, so the ranks' epochs agree."""
        self._epoch += 1
        return self._epoch

    def sem(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s row of the semaphore area."""
        return self.group.sems[rank]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise KampingError(
                "shard_map: no CUDA device is available; pass device='cpu' "
                "to run the ranks on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise KampingError(f"shard_map: ranks run on 'cuda' or 'cpu', not "
                           f"{dev}")
    return dev


def _stack(results, device):
    """Every rank's (pytree) result, stacked leaf by leaf."""
    flat = [pytree.tree_flatten(r) for r in results]
    spec = flat[0][1]
    if any(s != spec for _, s in flat):
        raise KampingError("shard_map: the ranks returned results of "
                           "different structure")
    leaves = [torch.stack([torch.as_tensor(f[0][i], device=device)
                           for f in flat])
              for i in range(len(flat[0][0]))]
    return pytree.tree_unflatten(leaves, spec)


def shard_map(fn: Callable, *args, axis_name: str = "x", device="cuda",
              timeout: float = 60.0):
    """Run ``fn`` once per rank, each rank in its own thread on its own
    local shard: slice ``r`` of every ``(p, ...)`` argument, copied into a
    tensor of its own on ``device``.  The counterpart of
    ``jax.shard_map(fn, mesh=make_mesh((p,), (axis_name,)),
    in_specs=P(axis_name), out_specs=P(axis_name))``.

    Inside ``fn``, ``Communicator(axis_name)`` collectives meet the other
    ranks; ``size()`` is ``p`` and ``rank()`` this rank's index as a 0-d
    tensor on ``device``.  The results come back stacked ``(p, ...)`` on
    ``device``, after every rank's stream is synchronised.  Ranks run on
    CUDA unless ``device="cpu"`` is passed; a CUDA request without a card
    raises.  A rank that raises, a rendezvous not complete within
    ``timeout`` seconds, or a device ring kernel whose spin ran out raises
    here, and no rank is left waiting.
    """
    dev = _device(device)
    args = [a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
            for a in args]
    sizes = {int(a.shape[0]) for a in args if a.dim()}
    if len(sizes) != 1 or any(a.dim() == 0 for a in args):
        raise KampingError(
            f"shard_map({axis_name!r}): every argument needs the same "
            f"leading rank dimension; got sizes {sorted(sizes)}")
    p = sizes.pop()
    group = RankGroup(p, dev, timeout)
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    results: list = [None] * p
    errors: list = [None] * p
    done = threading.Semaphore(0)

    def run(r):
        rank = Rank(group, r)
        try:
            if rank.stream is None:
                results[r] = _run_rank(fn, args, rank, axis_name, dev)
            else:
                try:
                    with torch.cuda.device(dev), torch.cuda.stream(rank.stream):
                        rank.stream.wait_stream(caller)  # args, sems ready
                        out = _run_rank(fn, args, rank, axis_name, dev)
                        for leaf in pytree.tree_leaves(out):
                            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                                leaf.record_stream(caller)  # read by _stack
                        results[r] = out
                finally:
                    rank.stream.synchronize()  # ends in time: spins are bounded
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[r] = e
            group.abort()
        finally:
            done.release()

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"shard_map-{axis_name}-{r}")
               for r in range(p)]
    for t in threads:
        t.start()
    # Wait without limit while every rank runs; once one has ended, each
    # further rank must end within `timeout` of the one before.
    done.acquire()
    for _ in range(p - 1):
        if any(e is not None for e in errors):
            group.abort()
        if not done.acquire(timeout=timeout):
            group.abort()
            alive = [t.name for t in threads if t.is_alive()]
            raise KampingError(
                f"shard_map({axis_name!r}): {alive} did not finish within "
                f"{timeout} s of the rank before") from _first(errors)
    first = _first(errors)
    if first is not None:
        raise first
    if group.sems is not None:
        status = group.sems[:, -1].cpu()
        if bool(status.any()):
            raise KampingError(
                f"shard_map({axis_name!r}): a device ring kernel's spin ran "
                f"out (status by rank {status.tolist()}: 1 neighbour barrier, "
                f"2 arrival, 3 credit); its result is not valid")
    return _stack(results, dev)


def _first(errors):
    """The first rank error that is not only the echo of another's."""
    raised = [e for e in errors if e is not None]
    real = [e for e in raised if not isinstance(e, _Abandoned)]
    return (real or raised or [None])[0]


def _run_rank(fn, args, rank, axis_name, dev):
    local = [a[rank.rank].to(dev, copy=True).contiguous() for a in args]
    index = torch.tensor(rank.rank, dtype=torch.int64, device=dev)
    with bind_rank(axis_name, rank, index):
        return fn(*local)
