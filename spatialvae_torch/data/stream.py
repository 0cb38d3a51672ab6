"""Host-resident minibatches on their way to the device (``--no-preload``).

The JAX package streams a host-resident dataset by handing each step
``jnp.asarray(dataset.y[idx])`` and letting asynchronous dispatch overlap
the next copy with the step (``spatialvae_tpu/train/trainer.py:767-827``).
On the card that overlap has to be built: a copy from pageable memory is
synchronous, a ``pin_memory()`` per batch is a page-locked allocation every
step, and pinning the whole stack defeats the purpose (it exists for stacks
larger than memory).  So ``BatchStager`` keeps two staging slots of one
minibatch each, a pinned host buffer and a device buffer per array:

- the host gathers a batch's rows into the free slot's pinned buffer;
- a side stream copies it to the slot's device buffer (``non_blocking``),
  and the compute stream waits on that copy's event;
- after the consumer has launched its step, an event on the compute stream
  marks the slot; the slot is written again only after that event, so the
  host runs at most two steps ahead of the card.

Under a mesh's data-parallel step each rank stages its own rows of each
global batch alone (the trainer hands it those indices).  On the CPU the
rows are gathered into fresh arrays, with nothing to overlap.  Either way each batch reaches the consumer as float32, the values
a preloaded dataset's gather gives.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

SLOTS = 2


class BatchStager:
    """Minibatches of the rows of host ``arrays`` (numpy, or None) on
    ``device``, at most ``rows`` rows a batch."""

    def __init__(self, arrays: Sequence[Optional[np.ndarray]], rows: int,
                 device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # the CPU indexes the caller's arrays as they are; the card's
        # gathers write into the pinned buffers (``np.take``)
        self.arrays = list(arrays)
        if self.cuda:
            self.arrays = [None if a is None else np.asarray(a)
                           for a in arrays]
        self.slots = []
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.slots = [self._slot(rows) for _ in range(SLOTS)]
        self._next = 0

    def _slot(self, rows: int) -> dict:
        host, dev = [], []
        for a in self.arrays:
            if a is None:
                host.append(None)
                dev.append(None)
                continue
            dtype = torch.from_numpy(a[:0]).dtype
            shape = (rows,) + a.shape[1:]
            host.append(torch.empty(shape, dtype=dtype, pin_memory=True))
            dev.append(torch.empty(shape, dtype=dtype, device=self.device))
        return {"host": host, "dev": dev, "done": None}

    def batches(self, indices: Iterable) -> Iterable[List]:
        """For each index array of ``indices`` (rows of the arrays), the
        list of float32 batches on the device (None for an absent array).
        A batch is valid until the consumer asks for the one after the
        next: the slot's reuse waits on the work launched in between."""
        for idx in indices:
            idx = np.asarray(idx)
            if not self.cuda:
                yield [None if a is None else
                       torch.from_numpy(np.asarray(a[idx], np.float32))
                       for a in self.arrays]
                continue
            slot = self.slots[self._next]
            self._next = (self._next + 1) % SLOTS
            if slot["done"] is not None:
                slot["done"].synchronize()
            k = len(idx)
            with torch.cuda.stream(self.stream):
                for a, h, d in zip(self.arrays, slot["host"], slot["dev"]):
                    if a is not None:
                        np.take(a, idx, axis=0, out=h.numpy()[:k])
                        d[:k].copy_(h[:k], non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self.stream)
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(copied)
            yield [None if d is None else d[:k].to(torch.float32)
                   for d in slot["dev"]]
            done = torch.cuda.Event()
            done.record(compute)
            slot["done"] = done
