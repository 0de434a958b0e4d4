"""Quickstart on the PyTorch port: the paper's Fig. 1/Fig. 3 — a one-liner
allgatherv with inferred parameters, then progressively more explicit
control, over 8 emulated ranks (``repro_torch.core.spmd``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(CUDA by default, where the ring transport's collectives are the CUDA
ring kernels; without CUDA it raises unless --device cpu is given)
"""
import argparse
import operator

import torch

from repro_torch.core import (
    Communicator,
    get_transport,
    grow_only,
    op,
    recv_buf,
    recv_count_out,
    recv_counts_out,
    recv_displs_out,
    root,
    send_buf,
    send_count,
    send_counts,
    spmd,
)
from repro_torch.device import resolve_device

P = 8


def main(device=None, transport="ring"):
    device = resolve_device(device)

    # (1) concise code with sensible defaults — paper Fig. 1 version 1
    def version1(v):
        comm = Communicator("ranks", transport=transport)
        return comm.allgatherv(send_buf(v))  # counts & displs inferred

    v = torch.arange(P * 3, dtype=torch.float64, device=device).reshape(P, 3)
    v_global = spmd(version1, v, axis_name="ranks")
    print("v1  allgatherv one-liner ->", tuple(v_global.shape))

    # (2) detailed tuning of each parameter — paper Fig. 1 version 2:
    #     out-parameters requested explicitly; the capacity policy controls
    #     memory behaviour (grow_only = static bound, nothing launched)
    def version2(v, n):
        comm = Communicator("ranks", transport=transport)
        r = comm.allgatherv(
            send_buf(v),                   # (3)
            send_count(n),                 # per-rank valid-prefix length
            recv_counts_out(),             # (4) ask for counts back
            recv_displs_out(),             # (5)
            recv_buf(grow_only(3)),        # (6) capacity policy
        )
        return r.recv_buf, r.recv_counts, r.recv_displs

    counts = torch.tensor([1, 2, 3, 1, 2, 3, 1, 2], dtype=torch.int32,
                          device=device)
    buf, rc, rd = spmd(version2, v, counts, axis_name="ranks")
    print("v2  explicit outs       -> counts", rc[0].tolist())

    # (3) the same exchange, hand-rolled (paper Fig. 2) on the transport's
    #     primitives — compare verbosity
    def handrolled(v, n):
        comm = Communicator("ranks")
        t = get_transport(transport)
        rc = t.all_gather(comm, n, tiled=False)                # exchange counts
        rd = torch.cat([torch.zeros(1, dtype=torch.int32, device=rc.device),
                        torch.cumsum(rc, 0, dtype=torch.int32)[:-1]])
        buf = t.all_gather(comm, v)                            # padded gather
        return buf, rc, rd

    buf2, rc2, rd2 = spmd(handrolled, v, counts, axis_name="ranks")
    assert torch.equal(rc, rc2) and torch.equal(buf, buf2)
    print("v3  hand-rolled parity  -> identical counts and buffer, 3x the "
          "code")

    # (4) the completed surface, same named-parameter style: reduce_scatter,
    #     root-bucketed scatterv, and an auto-generated non-blocking
    #     variant — all rows of the same op-spec table
    def version4(contrib, rootbuf, sc):
        comm = Communicator("ranks", transport=transport)
        reduced = comm.reduce_scatter(send_buf(contrib), op(operator.add))
        r = comm.scatterv(send_buf(rootbuf), send_counts(sc),
                          recv_count_out(), root(0))
        req = comm.iallgatherv(send_buf(reduced))  # non-blocking
        return reduced, r.recv_buf, r.recv_count, req.wait()

    contrib = torch.ones((P, P, 2), dtype=torch.float32, device=device)
    rootbuf = torch.arange(P * 3, dtype=torch.float32,
                           device=device).reshape(1, P, 3).repeat(P, 1, 1)
    sc = torch.tensor([1, 2, 3, 1, 2, 3, 1, 2], dtype=torch.int32,
                      device=device).repeat(P, 1)
    red, mine, cnt, gathered = spmd(version4, contrib, rootbuf, sc,
                                    axis_name="ranks")
    assert (red == P).all()  # sum of 8 ranks' ones
    assert torch.equal(mine, rootbuf[0])
    assert torch.equal(gathered[0], red.reshape(-1))
    print("v4  reduce_scatter/scatterv/iallgatherv ->", tuple(red.shape),
          tuple(mine.shape), cnt.tolist())
    print(f"quickstart OK ({device.type}, {transport})")
    return red, mine, cnt, gathered


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--transport", default="ring")
    a = ap.parse_args()
    main(a.device, a.transport)
