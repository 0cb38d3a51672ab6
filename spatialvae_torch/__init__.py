"""spatialvae_torch — the PyTorch/CUDA port of ``spatialvae_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``transforms``, ``nn``, ``models``, ``objectives``, ``kernels``, ``io``,
``checkpoint``, ``api``) so each module's counterpart is found by name.
Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper (``kernels/csrc``) with its plain
PyTorch version beside it.

The port imports nothing of JAX and nothing of ``spatialvae_tpu``: it keeps
its own copies of the config dataclasses (``config.py``) and of the
reference ``.sav`` reader (``io/reference_sav.py``).  Its entry points
(``api.SpatialVae.load``, ``train.trainer.Trainer``) run on the CUDA card
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
