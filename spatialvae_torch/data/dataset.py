"""The dataset of a training run — counterpart of
``spatialvae_tpu/data/dataset.py``.

``ArrayDataset`` keeps the images (N, ...) and, for cryo-EM particles, the
per-image CTF kernels (N, kn, km) on one device; the trainer gathers each
minibatch's rows there.  With ``preload=False`` (the CLI's
``--no-preload``) the arrays stay numpy arrays on the host
(``host_resident``) and the trainer streams one minibatch per step to the
device, for stacks larger than the card's memory.  Under a mesh every rank
holds the whole data set (the JAX CLI shards it over 'data'): each takes
its rows of every global batch (ROADMAP M10's decision).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch


@dataclass
class ArrayDataset:
    """y: (N, ...) images; ctf: optional (N, kn, km) per-image CTF
    kernels; both float32 on one device, or, when ``host_resident``, numpy
    arrays on the host in their own dtype."""

    y: Union[torch.Tensor, np.ndarray]
    ctf: Optional[Union[torch.Tensor, np.ndarray]] = None
    host_resident: bool = False

    def __len__(self) -> int:
        return self.y.shape[0]

    @staticmethod
    def from_numpy(y: np.ndarray, ctf: Optional[np.ndarray] = None,
                   device=None, preload: bool = True) -> "ArrayDataset":
        """Copy the arrays to ``device`` (the card unless named) as
        float32; with ``preload=False`` keep them on the host as they
        are."""
        if not preload:
            return ArrayDataset(y=np.asarray(y),
                                ctf=None if ctf is None else np.asarray(ctf),
                                host_resident=True)
        from spatialvae_torch.device import resolve_device

        dev = resolve_device(device)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        return ArrayDataset(y=put(y), ctf=None if ctf is None else put(ctf))
