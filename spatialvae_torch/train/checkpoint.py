"""Checkpoint cadence, file names and background writes — counterpart of
``spatialvae_tpu/train/checkpoint.py`` (the payloads live in
``spatialvae_torch/checkpoint.py``).

File names follow the reference: ``{prefix}_generator_epoch{E}.sav``,
``{prefix}_inference_epoch{E}.sav`` and ``{prefix}_optimizer_epoch{E}.sav``,
the epoch zero-padded to ``digits`` (``int(log10(num_epochs)) + 1``), in
``trained_dir`` when one is given.  ``save_trained_models`` writes both
networks every ``save_interval`` epochs.  Writes go to one background
thread, so an epoch loop never waits on the disk; the payload is copied to
the host before its write is queued, so a later Adam step cannot change
what is written.  ``wait_for_checkpoints`` blocks until every queued write
has finished (and raises the first write's error); the queue is drained at
interpreter exit too.  Under a mesh rank 0 alone writes (every rank holds
the same weights); every rank reads on resume.
"""

from __future__ import annotations

import atexit
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

from spatialvae_torch import checkpoint
from spatialvae_torch.parallel.mesh import primary

_writer = ThreadPoolExecutor(max_workers=1)
_pending = []


def _drain() -> None:
    try:
        for f in _pending:
            f.result()
    finally:
        _pending.clear()


atexit.register(_drain)


def wait_for_checkpoints() -> None:
    """Block until all background checkpoint writes have finished."""
    _drain()


def _write(path: str, payload: dict, async_write: bool) -> None:
    if not primary():           # a mesh's rank 0 alone writes
        return
    if async_write:
        _pending.append(_writer.submit(checkpoint.write_payload, path,
                                       payload))
    else:
        checkpoint.write_payload(path, payload)


def save_model(path: str, kind: str, module, async_write: bool = False, *,
               elbo=None, image_shape=None) -> None:
    """``checkpoint.save_model``, optionally on the background thread."""
    _write(path, checkpoint.model_payload(kind, module, elbo=elbo,
                                          image_shape=image_shape),
           async_write)


def save_optimizer(path: str, state, epoch: int, q_net, p_net,
                   async_write: bool = False) -> None:
    """``checkpoint.save_optimizer``, optionally on the background
    thread."""
    _write(path, checkpoint.optimizer_payload(state, epoch, q_net, p_net),
           async_write)


def optimizer_path(prefix: str, epoch: int, digits: int,
                   trained_dir: Optional[str] = None) -> str:
    e = str(epoch + 1).zfill(digits)
    opt = f"{prefix}_optimizer_epoch{e}.sav"
    if trained_dir is not None:
        opt = os.path.join(trained_dir, opt)
    return opt


def checkpoint_paths(prefix: str, epoch: int, digits: int,
                     trained_dir: Optional[str] = None) -> Tuple[str, str]:
    e = str(epoch + 1).zfill(digits)
    gen = f"{prefix}_generator_epoch{e}.sav"
    inf = f"{prefix}_inference_epoch{e}.sav"
    if trained_dir is not None:
        gen = os.path.join(trained_dir, gen)
        inf = os.path.join(trained_dir, inf)
    return gen, inf


def save_trained_models(prefix: Optional[str], epoch: int, digits: int,
                        save_interval: int, trained_dir: Optional[str],
                        p_net, q_net, async_write: bool = True, *,
                        elbo=None, image_shape=None) -> bool:
    """Write both networks after 0-based ``epoch`` when a prefix is given
    and epoch + 1 is a multiple of ``save_interval``; returns whether it
    did."""
    if prefix is None or (epoch + 1) % save_interval != 0:
        return False
    gen, inf = checkpoint_paths(prefix, epoch, digits, trained_dir)
    save_model(gen, "generator", p_net, async_write, elbo=elbo,
               image_shape=image_shape)
    save_model(inf, "inference", q_net, async_write, elbo=elbo,
               image_shape=image_shape)
    return True
