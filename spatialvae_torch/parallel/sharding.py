"""What each rank holds — counterpart of ``spatialvae_tpu/parallel/sharding.py``.

- batches: ``P("data")`` splits a global batch's rows into contiguous
  blocks, block d on data index d; ``batch_sharding(mesh)`` gives this
  rank's block (the model ranks of one data index share it);
- parameters: replicated, every rank holding all of them; ``replicated``
  broadcasts rank 0's at the start so every rank begins from the same
  weights, and the steps keep them equal (every rank runs Adam on the same
  reduced gradients).  ``param_shardings``/``shard_params`` lay out a mesh
  without a model axis, or the pixel step's (whose parameters are
  replicated too): everything replicated.

The JAX package's tensor-parallel q first layer (its ``tp_mode``, column
or row) and its GSPMD activation-sharding hooks
(``set_activation_sharding``, ``activation_sharding_scope``,
``constrain_decoder_hidden``), which mean nothing without GSPMD, are
ROADMAP M10b: a model axis that the pixel step cannot take raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spatialvae_torch.parallel.collectives import broadcast_


def tensor_parallel_refusal(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} takes the JAX package's GSPMD tensor-parallel path (the "
        f"q first layer split over 'model'), which is not ported yet "
        f"(ROADMAP M10b)")


@dataclass(frozen=True)
class BatchSharding:
    """Block ``index`` of ``count`` contiguous blocks of a batch's rows."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.count} data ranks")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rows(t.shape[0])]


def batch_sharding(mesh) -> BatchSharding:
    """This rank's rows of a global batch (``P("data")``)."""
    return BatchSharding(mesh.data_index, mesh.shape["data"])


def replicated(tensors) -> None:
    """Every rank's ``tensors`` (an iterable, or a dict's values) set to
    rank 0's, in place."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    broadcast_(tensors, src=0)


def param_shardings(params: dict, mesh, pixel_step: bool = False) -> dict:
    """name -> "replicated" for every parameter, on a mesh without a model
    axis or under the pixel step; a model axis off the pixel step takes the
    tensor-parallel layout, which raises (M10b)."""
    if mesh.shape["model"] > 1 and not pixel_step:
        raise tensor_parallel_refusal(f"a model axis of "
                                      f"{mesh.shape['model']}")
    return dict.fromkeys(params, "replicated")


def shard_params(params: dict, mesh, pixel_step: bool = False) -> dict:
    """``params`` laid out by ``param_shardings``: rank 0's values on
    every rank, in place; returns ``params``."""
    param_shardings(params, mesh, pixel_step)
    replicated(params)
    return params
