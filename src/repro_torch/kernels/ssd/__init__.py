"""Mamba-2 SSD chunked scan: CUDA kernel (csrc/), plain versions (ref.py)
and the wrapper (ops.py)."""
