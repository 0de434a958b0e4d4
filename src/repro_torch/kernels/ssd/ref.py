"""Plain PyTorch versions of the SSD chunked-scan kernel.

:func:`ssd_scan_ref` is the chunked oracle of the JAX package
(``repro/models/ssd.py`` ``ssd_scan_ref``): within chunks of length
``Q = min(chunk, S)`` a masked quadratic product, across chunks an
``(H, N, P)`` state carried by a ``(B, nc, ...)`` recurrence.
:func:`ssd_sequential_ref` is the token-by-token recurrence both must
match (``repro/kernels/ssd/ref.py``).  Both compute in fp32 and return
``x``'s dtype.  The wrapper (``ops.py``) takes :func:`ssd_scan_ref` for
CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against it on the
card.

Shapes: x (B, S, H, P) with dt folded in; a (B, S, H) per-head decay;
Bm, C (B, S, G, N), group ``h // (H // G)`` for head ``h``.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref", "ssd_sequential_ref", "chunk_len"]


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length ``Q = min(chunk, S)``; raises ``ValueError`` unless
    ``S % Q == 0`` (the JAX functions assert it)."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan: seq {S} must be divisible by chunk {Q}")
    return Q


def ssd_scan_ref(x, a, Bm, C, chunk=128):
    """Chunked SSD scan.  x: (B,S,H,P); a: (B,S,H); Bm, C: (B,S,G,N)
    -> y: (B,S,H,P) in x's dtype."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = chunk_len(S, chunk)
    nc = S // Q

    xc = x.reshape(Bsz, nc, Q, H, P).float()
    ac = a.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, G, N).float()
    Cc = C.reshape(Bsz, nc, Q, G, N).float()

    la = torch.cumsum(torch.log(torch.clamp_min(ac, 1e-37)), dim=2)
    # intra-chunk: y_d[i] = sum_{j<=i} C_i.B_j exp(la_i - la_j) x_j; the
    # anti-causal entries have seg > 0 and overflow, so mask BEFORE exp
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal[None, None, :, :, None], seg, -torch.inf)
    decay = torch.exp(seg)
    cb = torch.einsum("bnigk,bnjgk->bnijg", Cc, Bc)  # (B,nc,Qi,Qj,G)
    w = cb.repeat_interleave(rep, dim=-1) * decay
    y_diag = torch.einsum("bnijh,bnjhp->bnihp", w, xc)

    # chunk states: state_n = sum_j exp(la_last - la_j) B_j x_j^T (H,N,P)
    tail = torch.exp(la[:, :, -1:, :] - la)  # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    cs = torch.einsum("bnqh,bnqhk,bnqhp->bnhkp", tail, Bh, xc)
    # inter-chunk recurrence S_n = decay_n * S_{n-1} + cs_n; chunk n reads
    # the state before it
    chunk_decay = torch.exp(la[:, :, -1, :])  # (B,nc,H)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + cs[:, n]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,N,P)

    # inter-chunk contribution: y_off[i] = exp(la_i) C_i . S_prev
    Ch = Cc.repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    y_off = torch.einsum("bnqh,bnqhk,bnhkp->bnqhp", torch.exp(la), Ch,
                         prev_states)
    return (y_diag + y_off).reshape(Bsz, S, H, P).to(x.dtype)


def ssd_sequential_ref(x, a, Bm, C):
    """Token-by-token recurrence: S_t = a_t S_{t-1} + B_t x_t^T;
    y_t = C_t . S_t.  x: (B,S,H,P); a: (B,S,H); Bm/C: (B,S,G,N)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.float().repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, af = x.float(), a.float()
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = state * af[:, t, :, None, None] + torch.einsum(
            "bhk,bhp->bhkp", Bh[:, t], xf[:, t])
        ys.append(torch.einsum("bhk,bhkp->bhp", Ch[:, t], state))
    if not ys:
        return torch.empty_like(x)
    return torch.stack(ys, dim=1).to(x.dtype)
