"""spatialvae_torch — the PyTorch/CUDA port of ``spatialvae_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``transforms``, ``nn``, ``models``, ``objectives``, ``kernels``, ``io``,
``checkpoint``, ``api``) so each module's counterpart is found by name.
Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper (``kernels/csrc``) with its plain
PyTorch version beside it.

The port imports no JAX.  From the old package it reuses only the two
JAX-free modules ``spatialvae_tpu.core.config`` (frozen config dataclasses)
and ``spatialvae_tpu.io.torch_import`` (reference ``.sav`` conversion).
"""

__version__ = "0.1.0"
