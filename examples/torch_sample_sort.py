"""Distributed sample sort (paper §IV-A, Fig. 7) on the PyTorch port.

The paper's "textbook algorithm in 16 lines" over emulated ranks: sample
splitters, allgather them, bucket locally, exchange buckets with
``alltoallv`` (receive counts inferred), sort locally.  The ranks run
under ``repro_torch.core.spmd``; on the ``ring`` transport the allgather
and the two alltoalls (buckets, counts transpose) are the CUDA ring
kernels on a CUDA tensor.

Run:  PYTHONPATH=src python examples/torch_sample_sort.py [--device cpu]
(CUDA by default; without CUDA it raises unless --device cpu is given)
"""
import argparse

import torch

from repro_torch.core import (
    Communicator,
    bucketize_by_destination,
    recv_counts_out,
    send_buf,
    send_counts,
    spmd,
)
from repro_torch.device import resolve_device

OVERSAMPLE = 16
PAD = torch.iinfo(torch.int32).max  # sorts to the tail of every bucket


def capacity(n_per_rank: int, p: int) -> int:
    """Per-destination bucket capacity: the example's static bound."""
    return int(n_per_rank * 2.5 / p) * 2


def sample_sort(data, gen, *, transport="ring"):
    """Sort the ``(p, n)`` int32 keys of ``p`` ranks.

    Returns ``(merged, valid)``: rank r's received keys sorted, ``(p,
    p*cap)`` with PAD in the tail, and each rank's count of real keys.
    Concatenating ``merged[r, :valid[r]]`` over r gives the sorted input.
    Sample positions come from ``gen`` (``OVERSAMPLE`` distinct positions
    per rank).
    """
    p, n = data.shape
    cap = capacity(n, p)
    picks = torch.stack([
        torch.randperm(n, generator=gen, device=gen.device)[:OVERSAMPLE]
        for _ in range(p)
    ]).to(data.device)
    samples = torch.gather(data, 1, picks)

    def rank_program(local, mine):
        comm = Communicator("ranks", transport=transport)
        # 1. local samples -> global splitters (allgather, Fig. 7)
        gsamples = torch.sort(comm.allgather(send_buf(mine))).values
        splitters = gsamples[OVERSAMPLE::OVERSAMPLE][: p - 1].contiguous()
        # 2. bucket by destination rank (static capacity)
        dest = torch.searchsorted(splitters, local)
        buckets, counts = bucketize_by_destination(local, dest, p, cap,
                                                   pad_value=PAD)
        # 3. exchange buckets — the receiver's counts inferred by the
        #    library (one counts transpose)
        r = comm.alltoallv(send_buf(buckets), send_counts(counts),
                           recv_counts_out())
        # 4. local sort (padding sorts to the tail)
        merged = torch.sort(r.recv_buf.reshape(-1)).values
        return merged, r.recv_counts.sum()

    return spmd(rank_program, data, samples, axis_name="ranks")


def gather_sorted(merged, valid):
    """The valid prefixes of every rank, concatenated."""
    return torch.cat([merged[r, : int(valid[r])]
                      for r in range(merged.shape[0])])


def main(device=None, n_per_rank=1 << 12, p=8, transport="ring", seed=0):
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.randint(0, 1 << 30, (p, n_per_rank), generator=gen,
                         device=device, dtype=torch.int32)
    merged, valid = sample_sort(data, gen, transport=transport)
    out = gather_sorted(merged, valid)
    if not torch.equal(out, torch.sort(data.reshape(-1)).values):
        raise AssertionError("sample sort disagrees with torch.sort")
    skew = float(valid.max()) / n_per_rank
    print(f"sample sort OK: {data.numel()} keys over {p} ranks on "
          f"{device.type} ({transport}); bucket skew {skew:.2f}x")
    return data, out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--n-per-rank", type=int, default=1 << 12)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--transport", default="ring")
    a = ap.parse_args()
    main(a.device, a.n_per_rank, a.ranks, a.transport)
