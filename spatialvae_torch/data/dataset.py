"""The dataset held on the device — counterpart of
``spatialvae_tpu/data/dataset.py``.

``ArrayDataset`` keeps the images (N, ...) and, for cryo-EM particles, the
per-image CTF kernels (N, kn, km) on one device; the trainer gathers each
minibatch's rows there.  The JAX package's ``host_resident`` streaming
(``--no-preload``) is not ported yet (ROADMAP M4; the CLI refuses the
flag).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class ArrayDataset:
    """y: (N, ...) images; ctf: optional (N, kn, km) per-image CTF
    kernels; both float32 on one device."""

    y: torch.Tensor
    ctf: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.y.shape[0]

    @staticmethod
    def from_numpy(y: np.ndarray, ctf: Optional[np.ndarray] = None,
                   device=None) -> "ArrayDataset":
        """Copy the arrays to ``device`` (the card unless named) as
        float32."""
        from spatialvae_torch.device import resolve_device

        dev = resolve_device(device)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        return ArrayDataset(y=put(y), ctf=None if ctf is None else put(ctf))
