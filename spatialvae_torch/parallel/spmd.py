"""The mesh's training and evaluation steps — counterpart of
``spatialvae_tpu/parallel/spmd.py``.

The JAX package's ``shard_map`` bodies run on every device of the mesh;
here each rank runs its own body and the collectives that ``shard_map``
implies are explicit (``parallel/collectives.py``):

- ``make_spmd_step``, data parallelism (a mesh without a model axis): the
  one-device step's loss and gradient on the rank's rows, then the
  gradients and the metrics averaged over 'data' (``pmean``), then the
  trainer's Adam on them, which every rank runs alike, so the parameters,
  the bf16 shadow and the int8 copies stay equal on every rank;
- ``make_spmd_pixel_step``, the pixel step (a model axis): the encoder and
  the pose fold on the rank's rows, K3 on its pixel slice of the grid,
  ``elbo_minibatch``'s ``pixel_axis`` hook making the metrics the whole
  image's, then the gradient partials summed over 'model' and averaged over
  'data';
- ``make_spmd_eval_step``: the evaluation's forward (K1, or K4 in int8
  mode; never the loss kernel) on the rank's rows, with the noise drawn
  once for the whole batch, as one device draws it, and sliced; the
  metrics averaged over 'data'.

The reparameterisation noise of a training step comes from the trainer's
generator for the rank's data index (``Trainer._step_gen``, the JAX
``fold_in`` of the shard index); the ranks of one data index share it.
Callers that need chosen noise pass ``noise=`` (the rank's rows).
"""

from __future__ import annotations

import torch

from spatialvae_torch.objectives.elbo import loss_terms
from spatialvae_torch.parallel.collectives import all_mean, all_sum
from spatialvae_torch.parallel.pixel import pixel_slice
from spatialvae_torch.parallel.sharding import batch_sharding


def _reduced(aux: torch.Tensor, grads: dict, axis) -> tuple:
    names = list(grads)
    out = all_mean([aux] + [grads[k] for k in names], axis)
    return out[0], dict(zip(names, out[1:]))


def make_spmd_step(trainer, mesh):
    """step(y, **kw) -> aux: the data-parallel step on this rank's rows y
    (``Trainer.train_step``'s keywords); the metrics are the global
    batch's."""
    if mesh.shape["model"] != 1:
        raise ValueError("the data-parallel step takes a mesh without a "
                         "model axis; make_spmd_pixel_step takes one")
    data = mesh.axis("data")

    def step(y, *, at=None, **kw):
        aux, grads = trainer.local_gradients(y, **kw)
        aux, grads = _reduced(aux, grads, data)
        trainer.update(aux, grads, at)
        return aux

    return step


def make_spmd_pixel_step(trainer, mesh):
    """step(y, *, y_t, **kw) -> aux: the pixel step on this rank's rows y;
    ``y_t`` their targets over the whole grid (sliced here) or over the
    rank's pixel slice.  The trainer gates it
    (``pixel.pixel_step_refusal``): the rows divide over 'data', the pixels
    over 'model' into tile-aligned slices, and K3 takes the slice's
    shapes."""
    if mesh.shape["model"] < 2:
        raise ValueError("the pixel step needs a model axis; "
                         "make_spmd_step takes a mesh without one")
    data, model = mesh.axis("data"), mesh.axis("model")
    hw = trainer.coords.shape[0]
    sl = pixel_slice(hw, model)
    coords = trainer.coords[sl].contiguous()
    mask = None if trainer.mask is None else trainer.mask[sl].contiguous()

    def step(y, *, y_t=None, at=None, **kw):
        if y_t is None:
            raise ValueError("the pixel step needs the targets' copy y_t; "
                             "batches without it run whole on every rank")
        if y_t.shape[-1] == hw:
            y_t = y_t[..., sl]
        aux, grads = trainer.local_gradients(
            y, y_t=y_t.contiguous(), coords=coords, mask=mask,
            pixel_axis=model, **kw)
        names = list(grads)
        summed = all_sum([grads[k] for k in names], model)
        aux, grads = _reduced(aux, dict(zip(names, summed)), data)
        trainer.update(aux, grads, at)
        return aux

    return step


def make_spmd_eval_step(trainer, mesh):
    """step(y, ctf, generator, z_scale) -> aux: the evaluation of the whole
    batch y (every rank passes it); a batch that does not divide over
    'data' runs whole on every rank.  Under no_grad, as ``eval_epoch``."""
    data = mesh.axis("data")
    rows = batch_sharding(mesh)

    def step(y, ctf, generator, z_scale=1.0):
        b = y.shape[0]
        noise = torch.randn((b, trainer.q_cfg.latent_dim),
                            generator=generator,
                            dtype=trainer.compute_dtype,
                            device=trainer.device)
        split = b % data.size == 0
        if split:
            y, noise = rows(y), rows(noise)
            ctf = None if ctf is None else rows(ctf)
        with torch.no_grad():
            _, aux = loss_terms(
                trainer.q_net, trainer.p_net, trainer._nonstep_ecfg,
                trainer.coords, y, noise=noise, z_scale=z_scale,
                mask=trainer.mask, ctf=ctf,
                image_shape=trainer.tcfg.image_shape,
                compute_dtype=trainer.compute_dtype)
        return all_mean([aux], data)[0] if split else aux

    return step
