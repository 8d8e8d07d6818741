"""penroz_tpu_torch — the PyTorch/CUDA port of ``penroz_tpu`` for NVIDIA
Hopper (H100).

Same layer DSL, parameter key names, ``PENROZC1`` checkpoint container and
REST routes as the JAX package, which stays the reference.  Plain tensor
code is PyTorch; every TPU kernel on a ported path is a hand-written CUDA
kernel under ``csrc/``, built with nvcc at first use
(``ops/kernels/build.py``).  The package imports torch, numpy and the
standard library only — never jax, optax or ``penroz_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.py``); there is no silent CPU fallback.
"""
