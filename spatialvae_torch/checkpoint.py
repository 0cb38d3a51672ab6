"""Checkpoints in the JAX package's own payload format.

Counterpart of ``spatialvae_tpu/train/checkpoint.py`` (model checkpoints
only).  A checkpoint is a pickle of

    {"format": FORMAT, "kind": "generator" | "inference",
     "config": config dict, "params": numpy tree in (fan_in, fan_out),
     "elbo": ElboConfig dict (optional), "image_shape": (n, m) (optional)}

so a file written by either package loads in the other.  Reference torch
``.sav`` files (whole-module pickles) are detected and converted through
``spatialvae_tpu.io.torch_import``, as the JAX loader does.  Unpickling runs
arbitrary code: load only checkpoints you trust.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

from spatialvae_tpu.core import config as core_config
from spatialvae_torch.io.jax_params import generator_to_jax, inference_to_jax
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.objectives.elbo import ElboConfig

FORMAT = "spatialvae_tpu.checkpoint.v1"


def config_from_dict(d: dict):
    """Config dataclass from its persisted dict.  ElboConfig is built as the
    port's own (the JAX one imports JAX); unknown fields are dropped."""
    if d.get("__class__") == "ElboConfig":
        known = {f.name for f in dataclasses.fields(ElboConfig)}
        return ElboConfig(**{k: v for k, v in d.items() if k in known})
    return core_config.config_from_dict(d)


def save_model(path: str, kind: str, module, *, elbo=None,
               image_shape=None) -> None:
    """Write ``module`` (an InferenceNetwork or SpatialGenerator) with its
    config and, optionally, the ELBO/pose config and image shape that
    serving needs."""
    is_inf = isinstance(module, InferenceNetwork)
    if kind != ("inference" if is_inf else "generator"):
        raise ValueError(f"kind={kind!r} does not match {type(module).__name__}")
    payload = {
        "format": FORMAT,
        "kind": kind,
        "config": core_config.config_to_dict(module.cfg),
        "params": (inference_to_jax if is_inf else generator_to_jax)(module),
    }
    if elbo is not None:
        payload["elbo"] = core_config.config_to_dict(elbo)
    if image_shape is not None:
        payload["image_shape"] = tuple(int(v) for v in image_shape)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _load_reference_sav(path: str):
    from spatialvae_tpu.io.torch_import import import_module, \
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
