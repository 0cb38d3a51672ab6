"""Checkpoints in the JAX package's own payload format.

Counterpart of ``spatialvae_tpu/train/checkpoint.py`` (model and optimizer
checkpoints).  A checkpoint is a pickle of

    {"format": FORMAT, "kind": "generator" | "inference",
     "config": config dict, "params": numpy tree in (fan_in, fan_out),
     "elbo": ElboConfig dict (optional), "image_shape": (n, m) (optional)}

or, for the Adam state,

    {"format": FORMAT, "kind": "optimizer", "epoch": int, "count": int,
     "mu": {"q": tree, "p": tree}, "nu": {"q": tree, "p": tree}}

so a file written by either package loads in the other, and a run trained
by the port resumes in either.  Adam states with bf16 moments
(``SPATIALVAE_ADAM_MOMENTS=bf16``) are refused both ways: the JAX package
pickles them as ``ml_dtypes`` arrays, which need a package the port does
not use (ROADMAP M9c-2).  Reference torch
``.sav`` files (whole-module pickles) are detected and converted through
``io/reference_sav.py``, as the JAX loader does.  Unpickling runs
arbitrary code: load only checkpoints you trust.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from spatialvae_torch.config import config_from_dict, config_to_dict
from spatialvae_torch.io.jax_params import (
    generator_to_jax,
    inference_to_jax,
    named_from_jax,
    named_to_jax,
)
from spatialvae_torch.models.inference import InferenceNetwork

FORMAT = "spatialvae_tpu.checkpoint.v1"


def _bf16_moments() -> NotImplementedError:
    return NotImplementedError(
        "an optimizer checkpoint with bf16 moments is not ported yet "
        "(ROADMAP M9c-2)")


def write_payload(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def save_model(path: str, kind: str, module, *, elbo=None,
               image_shape=None) -> None:
    """Write ``module`` (an InferenceNetwork, SpatialGenerator or
    VanillaGenerator) with its config and, optionally, the ELBO/pose
    config and image shape that serving needs."""
    write_payload(path, model_payload(kind, module, elbo=elbo,
                                      image_shape=image_shape))


def model_payload(kind: str, module, *, elbo=None,
                  image_shape=None) -> dict:
    """``save_model``'s payload, its arrays copied to the host."""
    is_inf = isinstance(module, InferenceNetwork)
    if kind != ("inference" if is_inf else "generator"):
        raise ValueError(f"kind={kind!r} does not match {type(module).__name__}")
    payload = {
        "format": FORMAT,
        "kind": kind,
        "config": config_to_dict(module.cfg),
        "params": (inference_to_jax if is_inf else generator_to_jax)(module),
    }
    if elbo is not None:
        payload["elbo"] = config_to_dict(elbo)
    if image_shape is not None:
        payload["image_shape"] = tuple(int(v) for v in image_shape)
    return payload


def _load_reference_sav(path: str):
    from spatialvae_torch.io.reference_sav import import_module, \
        load_torch_module

    params, cfg, kind = import_module(load_torch_module(path))
    return params, cfg, kind, {"elbo": None, "image_shape": None}


def load_model_meta(path: str):
    """Returns (params, config, kind, meta), meta = {'elbo': ElboConfig |
    None, 'image_shape': (n, m) | None}; params is the numpy tree."""
    with open(path, "rb") as f:
        if f.read(4) == b"PK\x03\x04":           # torch zipfile container
            return _load_reference_sav(path)
        f.seek(0)
        try:
            payload = pickle.load(f)
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ImportError, ValueError):
            payload = None     # legacy torch needs torch's own unpickler
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        try:
            return _load_reference_sav(path)
        except Exception as e:
            raise ValueError(
                f"{path} is neither a {FORMAT} checkpoint nor a loadable "
                f"reference torch .sav ({type(e).__name__}: {e})") from e
    elbo = payload.get("elbo")
    meta = {
        "elbo": None if elbo is None else config_from_dict(elbo),
        "image_shape": payload.get("image_shape"),
    }
    return (payload["params"], config_from_dict(payload["config"]),
            payload["kind"], meta)


def save_optimizer(path: str, state, epoch: int, q_net, p_net) -> None:
    """Write the Adam state (count, mu, nu) and the epoch index, the moments
    as numpy trees in the JAX layout."""
    write_payload(path, optimizer_payload(state, epoch, q_net, p_net))


def optimizer_payload(state, epoch: int, q_net, p_net) -> dict:
    """``save_optimizer``'s payload, its arrays copied to the host."""
    from spatialvae_torch.train.optimizer import FusedAdamState

    if not isinstance(state, FusedAdamState):
        raise TypeError(f"not a FusedAdamState: {type(state).__name__}")
    if any(t.dtype != torch.float32 for t in state.mu.values()):
        raise _bf16_moments()
    payload = {
        "format": FORMAT,
        "kind": "optimizer",
        "epoch": int(epoch),
        "count": int(state.count),
        "mu": named_to_jax(q_net, p_net, state.mu),
        "nu": named_to_jax(q_net, p_net, state.nu),
    }
    return payload


def load_optimizer(path: str, q_net, p_net, device=None):
    """Returns (FusedAdamState, epoch), the moments on ``device``."""
    from spatialvae_torch.train.optimizer import FusedAdamState

    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except ModuleNotFoundError as e:       # ml_dtypes' bf16 arrays
            raise _bf16_moments() from e
    if not isinstance(payload, dict) or payload.get("format") != FORMAT \
            or payload.get("kind") != "optimizer":
        raise ValueError(f"{path} is not a {FORMAT} optimizer checkpoint")
    first = payload["mu"]["q"]["layers"][0]["w"]
    if getattr(first, "dtype", None) != np.float32:
        raise _bf16_moments()
    state = FusedAdamState(
        count=int(payload["count"]),
        mu=named_from_jax(payload["mu"], q_net, p_net, device),
        nu=named_from_jax(payload["nu"], q_net, p_net, device))
    return state, int(payload["epoch"])
