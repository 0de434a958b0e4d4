"""Ring collectives: CUDA kernels (csrc/), plain versions (ref.py) and the
wrappers (ops.py) behind the ``ring`` transport."""
