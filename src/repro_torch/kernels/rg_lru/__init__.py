"""RG-LRU linear-recurrence scan: CUDA kernel (csrc/), plain versions
(ref.py) and the wrapper (ops.py)."""
