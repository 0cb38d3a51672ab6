"""Measurement tools of the port, run as ``python -m
spatialvae_torch.tools.<name>``: counterparts of the JAX package's
``tools/`` on the card."""
