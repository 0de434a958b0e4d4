"""Flash-attention prefill: CUDA kernel (csrc/), plain version (ref.py) and
the wrapper (ops.py)."""
