"""Serving engine: continuous slot batching (DESIGN.md §11) on PyTorch.

Port of the JAX package's ``serve/engine.py`` for the dense layout, over
a KV ring (dense family), a recurrent SSD state (ssm family) or RG-LRU
states beside a KV ring of the local window (hybrid family):

* **Bucketed padded prefill** — prompts are right-padded to power-of-two
  buckets and prefilled with ``prefill(..., true_len=...)`` where that is
  exact (causal attention); a recurrent model prefills each prompt at its
  own length.  On a CUDA device the prefill attention is the hand-written
  flash kernel, and the SSD and RG-LRU scans their hand-written kernels.
* **Overlapped admission** — each admission's prefill is issued (CUDA
  work is asynchronous), wrapped in a
  :class:`~repro_torch.core.NonBlockingResult` and parked in a
  :class:`~repro_torch.core.RequestPool`; the decode step for the live
  slots is issued before the engine waits on any prefill.
* **Multi-replica decode** — ``num_replicas`` replicas of
  ``replica_shards`` serve ranks each.  The weights are replicated, so one
  ``decode_step`` runs over all ``N * S`` rows at once (the arithmetic is
  that of a per-rank decode); only the liveness exchange runs per rank,
  under ``spmd`` over the ``"serve"`` axis, through the port's
  ``Communicator``: a grouped ``allreduce`` over
  ``split_by(block=replica_shards)`` gives each pool's live count and a
  flat one the global count.

Caches carry a leading rank dimension, ``(N, S, n_layers, ...)`` (K/V
rows, SSD, RG-LRU and conv states); the splice of a prefill writes every
cache's rows ``(rank, slot)`` in place, and the decode step writes its
new rows in place through a ``(N*S, ...)`` view of the same storage.

Not ported yet, and refused with the ROADMAP item that ports it:
``kv_layout="paged"`` (A8), ``plan=`` other than ``None`` and
``replica_shards="auto"`` (A7).  The JAX engine's compile-count telemetry
(``prefill_cache_size``) has no counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
import operator
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import (
    Communicator,
    KampingError,
    NonBlockingResult,
    RequestPool,
    op as op_param,
    send_buf,
    spmd,
)
from ..device import resolve_device
from ..models import (
    block_pattern,
    decode_step,
    init_decode_caches,
    prefill,
    supports_padded_prefill,
)

__all__ = ["ServeEngine", "Request", "REPLICA_AXIS"]

REPLICA_AXIS = "serve"

# Smallest prompt bucket.
_MIN_BUCKET = 4


@dataclasses.dataclass
class Request:
    """One generation request (see the JAX package's ``Request``).

    ``max_new_tokens`` is the exact number of tokens generated, the first
    from the prefill logits; ``generated`` is filled by the engine.
    """

    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    generated: Optional[List[int]] = None
    rid: int = -1


class ServeEngine:
    """Continuous-batching engine over ``num_replicas`` slot pools.

    Parameters
    ----------
    cfg, params:
        Model config and the port's parameter dict, on ``device``.
    max_len:
        Per-slot cache capacity (the KV ring wraps beyond it).
    num_slots:
        Decode slots per replica.
    num_replicas, replica_shards:
        Replicas, and serve ranks per replica (``num_slots`` must divide
        evenly over them).
    prompt_buckets:
        Pad prompts to power-of-two buckets when exact for the config.
    device:
        ``None`` means CUDA (raises without it); the parameters must
        already live there.
    """

    def __init__(self, cfg, params, max_len: int, num_slots: int,
                 greedy: bool = True, num_replicas: int = 1,
                 replica_shards: int = 1, prompt_buckets: bool = True,
                 kv_layout: str = "dense", plan=None, device=None):
        if not greedy:
            raise KampingError("ServeEngine: only greedy decoding is "
                               "implemented (greedy=True)")
        if kv_layout == "paged":
            raise NotImplementedError(
                "ServeEngine: kv_layout='paged' is not ported yet "
                "(ROADMAP A8)"
            )
        if kv_layout != "dense":
            raise KampingError(
                f"ServeEngine: kv_layout={kv_layout!r}; expected 'dense'"
            )
        if replica_shards == "auto":
            raise NotImplementedError(
                "ServeEngine: replica_shards='auto' needs the fitted cost "
                "model, which is not ported yet (ROADMAP A7)"
            )
        if plan is not None:
            raise NotImplementedError(
                "ServeEngine: plan= needs the planner, which is not ported "
                "yet (ROADMAP A7)"
            )
        if num_replicas < 1 or replica_shards < 1:
            raise KampingError(
                "ServeEngine: num_replicas and replica_shards must be >= 1; "
                f"got {num_replicas}, {replica_shards}"
            )
        if num_slots < 1 or num_slots % replica_shards:
            raise KampingError(
                f"ServeEngine: num_slots={num_slots} must be a positive "
                f"multiple of replica_shards={replica_shards} (a replica's "
                "pool is sharded evenly over its serve ranks)"
            )
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise KampingError(
                f"ServeEngine: parameters on {params['embed'].device}, "
                f"engine device {self.device}"
            )
        self.num_ranks = num_replicas * replica_shards
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.num_slots = num_slots
        self.num_replicas = num_replicas
        self.replica_shards = replica_shards
        self.slots_per_rank = num_slots // replica_shards
        self.pad_prompts = bool(
            prompt_buckets and supports_padded_prefill(cfg, max_len, max_len)
        )

        # -- host-side pool state (rank-major layout) ----------------------
        N, S = self.num_ranks, self.slots_per_rank
        self.queues: List[List[Request]] = [[] for _ in range(num_replicas)]
        self.active: Dict[Tuple[int, int], Request] = {}
        self.finished: List[Request] = []
        self.remaining = np.zeros((N, S), np.int64)
        self.next_tokens = np.zeros((N, S), np.int32)
        self.slot_live = np.zeros((N, S), bool)
        self.slot_pending = np.zeros((N, S), bool)
        self.truncated = False

        self._pool = RequestPool()
        self._pending_meta: List[Tuple[int, int, Request]] = []
        self._next_rid = 0

        # -- device state: caches with a leading rank dimension -------------
        flat = init_decode_caches(cfg, N * S, max_len, self.device)
        self.caches = {k: v.view((N, S) + tuple(v.shape[1:]))
                       for k, v in flat.items()}

        self.phase_seconds = {"admit": 0.0, "prefill": 0.0, "decode": 0.0,
                              "reap": 0.0}
        self.counters = {"steps": 0, "prefills": 0, "decode_tokens": 0,
                         "prefill_tokens": 0}
        self.last_stats: Dict[str, Any] = {}

    # -- device programs ------------------------------------------------------
    def _prefill_fn(self, toks, n):
        """(1, bucket) padded prompt -> (prefill token (1,), row cache)."""
        logits, pcache = prefill(
            self.params, {"tokens": toks}, self.cfg, max_len=self.max_len,
            true_len=(n if self.pad_prompts else None),
        )
        return logits[:, 0, :].argmax(-1).to(torch.int32), pcache

    def _splice(self, pcache, rank, slot):
        """Copy a one-row prefill cache into rows (rank, slot), in place."""
        for key, rows in self.caches.items():
            rows[rank, slot] = pcache[key][0]

    def _liveness(self, still):
        """Per serve rank: the pool's and the global live-slot counts."""
        comm = Communicator(REPLICA_AXIS)
        pool_live = comm.split_by(block=self.replica_shards).allreduce(
            send_buf(still), op_param(operator.add)
        )
        global_live = comm.allreduce(send_buf(still), op_param(operator.add))
        return pool_live, global_live

    def _decode(self, toks, live, rem):
        """One decode step for every row of every serve rank."""
        N, S = self.num_ranks, self.slots_per_rank
        flat = {k: v.view((N * S,) + tuple(v.shape[2:]))
                for k, v in self.caches.items()}
        logits, nc = decode_step(self.params, flat, toks.view(N * S),
                                 self.cfg)
        self.caches["pos"] = nc["pos"].view(N, S)
        nxt = logits[:, 0, :].argmax(-1).to(torch.int32).view(N, S)
        # live after this step's budget spend: rem > 1 pre-decrement
        still = (live & (rem > 1)).sum(dim=1).to(torch.int32)
        pool_live, global_live = spmd(self._liveness, still,
                                      axis_name=REPLICA_AXIS)
        return nxt, pool_live, global_live

    # -- request management ----------------------------------------------------
    def submit(self, req: Request, replica: Optional[int] = None):
        """Queue a request; ``replica=None`` routes to the least-loaded
        replica.  A prompt longer than ``max_len`` raises here."""
        self._validate(req)
        req.generated = []
        if req.rid < 0:
            req.rid = self._next_rid
            self._next_rid += 1
        if replica is None:
            replica = min(
                range(self.num_replicas),
                key=lambda r: (len(self.queues[r]) + self._replica_load(r), r),
            )
        if not 0 <= replica < self.num_replicas:
            raise KampingError(
                f"ServeEngine.submit: replica={replica} out of range "
                f"[0, {self.num_replicas})"
            )
        self.queues[replica].append(req)

    def _replica_load(self, replica: int) -> int:
        lo = replica * self.replica_shards
        hi = lo + self.replica_shards
        return int(self.slot_live[lo:hi].sum() + self.slot_pending[lo:hi].sum())

    @property
    def queue(self) -> List[Request]:
        return [r for q in self.queues for r in q]

    def _validate(self, req: Request):
        n = int(len(req.prompt))
        if n < 1:
            raise KampingError("ServeEngine: empty prompt")
        if n > self.max_len:
            raise KampingError(
                f"ServeEngine: prompt length {n} exceeds the per-slot "
                f"capacity max_len={self.max_len}"
            )
        chunk = self.cfg.ssm_chunk
        if "ssd" in block_pattern(self.cfg) and n > chunk and n % chunk:
            raise KampingError(
                f"ServeEngine: prompt length {n} breaks the SSD chunk rule: "
                f"a prompt longer than ssm_chunk={chunk} must be a multiple "
                "of it"
            )

    def _bucket(self, n: int) -> int:
        if not self.pad_prompts:
            return n
        b = _MIN_BUCKET
        while b < n:
            b <<= 1
        return min(b, self.max_len)

    def _admit(self):
        """Issue (not complete) one prefill per free slot per queued
        request."""
        for rep in range(self.num_replicas):
            q = self.queues[rep]
            lo = rep * self.replica_shards
            for rank in range(lo, lo + self.replica_shards):
                for slot in range(self.slots_per_rank):
                    if not q:
                        break
                    if self.slot_live[rank, slot] or self.slot_pending[rank, slot]:
                        continue
                    req = q.pop(0)
                    S = int(len(req.prompt))
                    toks = np.zeros((1, self._bucket(S)), np.int64)
                    toks[0, :S] = np.asarray(req.prompt)
                    res = self._prefill_fn(
                        torch.as_tensor(toks, device=self.device),
                        torch.tensor([S], dtype=torch.int32,
                                     device=self.device),
                    )
                    self._pool.submit(
                        NonBlockingResult(res, op_name="serve_prefill")
                    )
                    self._pending_meta.append((rank, slot, req))
                    self.slot_pending[rank, slot] = True
                    self.counters["prefills"] += 1

    def _complete_prefills(self):
        """Drain the admission pool: splice each prefill's cache rows into
        its slot and hand the prefill token to the request.  A budget-1
        request finishes here without taking a decode slot."""
        if not self._pending_meta:
            return
        vals = self._pool.waitall()
        meta, self._pending_meta = self._pending_meta, []
        for (rank, slot, req), (tok, pcache) in zip(meta, vals):
            t = int(tok[0])
            req.generated.append(t)
            self.counters["prefill_tokens"] += 1
            self.slot_pending[rank, slot] = False
            if req.max_new_tokens <= 1:
                self.finished.append(req)
                continue
            self._splice(pcache, rank, slot)
            self.slot_live[rank, slot] = True
            self.next_tokens[rank, slot] = t
            self.remaining[rank, slot] = req.max_new_tokens - 1
            self.active[(rank, slot)] = req

    # -- stepping ----------------------------------------------------------------
    def step(self) -> int:
        """One engine step (admit, decode, prefill, reap — see the JAX
        engine); returns the number of live slots afterwards."""
        tic = time.perf_counter
        t0 = tic()
        self._admit()
        t1 = tic()
        out = None
        if self.slot_live.any():
            decoded = self.slot_live.copy()
            dev = self.device
            out = self._decode(
                torch.as_tensor(self.next_tokens, device=dev).long(),
                torch.as_tensor(self.slot_live, device=dev),
                torch.as_tensor(self.remaining.astype(np.int32), device=dev),
            )
        t2 = tic()
        self._complete_prefills()
        t3 = tic()
        t4 = t3
        if out is not None:
            nxt = out[0].cpu().numpy()  # host sync point for the decode batch
            t4 = tic()
            for (rank, slot), req in list(self.active.items()):
                if not decoded[rank, slot]:
                    continue  # spliced this step; first decode is next step
                tok = int(nxt[rank, slot])
                req.generated.append(tok)
                self.next_tokens[rank, slot] = tok
                self.remaining[rank, slot] -= 1
                self.counters["decode_tokens"] += 1
                if self.remaining[rank, slot] <= 0:
                    self.slot_live[rank, slot] = False
                    del self.active[(rank, slot)]
                    self.finished.append(req)
            self.last_stats = {
                "pool_live": out[1].cpu().numpy()[:: self.replica_shards].copy(),
                "global_live": int(out[2].reshape(-1)[0]),
            }
        t5 = tic()
        self.phase_seconds["admit"] += t1 - t0
        self.phase_seconds["decode"] += (t2 - t1) + (t4 - t3)
        self.phase_seconds["prefill"] += t3 - t2
        self.phase_seconds["reap"] += t5 - t4
        self.counters["steps"] += 1
        return int(self.slot_live.sum())

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        """Step until every submitted request has finished (or
        ``max_steps``); returns the requests finished during this call.
        Hitting ``max_steps`` with work outstanding sets :attr:`truncated`
        and warns (RuntimeWarning)."""
        start = len(self.finished)
        self.truncated = False
        steps = 0
        while self._outstanding() and steps < max_steps:
            self.step()
            steps += 1
        if self._outstanding():
            self.truncated = True
            warnings.warn(
                f"ServeEngine.run_to_completion: max_steps={max_steps} "
                f"reached with {sum(len(q) for q in self.queues)} queued, "
                f"{len(self.active)} live and {len(self._pending_meta)} "
                f"admitting request(s) outstanding; returning the "
                f"{len(self.finished) - start} finished so far",
                RuntimeWarning,
                stacklevel=2,
            )
        return self.finished[start:]

    def _outstanding(self) -> bool:
        return bool(any(self.queues) or self.active or self._pending_meta)

    def reset_stats(self):
        """Zero phase timers and counters (e.g. after a warmup run)."""
        for k in self.phase_seconds:
            self.phase_seconds[k] = 0.0
        for k in self.counters:
            self.counters[k] = 0
