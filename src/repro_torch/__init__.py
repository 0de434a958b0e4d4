"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

Mirrors ``repro``'s module paths.  Imports ``torch`` and never ``jax`` or
``repro``; the JAX package is the reference each ported module is tested
against (tests/test_torch_*.py).
"""
