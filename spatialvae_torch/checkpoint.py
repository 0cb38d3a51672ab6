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
(``SPATIALVAE_ADAM_MOMENTS=bf16``) travel in the JAX package's own form,
``ml_dtypes.bfloat16`` numpy arrays, without the port importing
``ml_dtypes`` (the card's machine has none): the reader maps that dtype to
its 2-byte bits (``_Unpickler``) and widens them exactly, and the writer
emits each moment as ``numpy.ndarray(shape,
numpy.dtype(importlib.import_module("ml_dtypes").bfloat16), bits)``
(``_Pickler``), which the JAX package's ``pickle.load`` reads as bf16
arrays with the same bits.  Reference torch
``.sav`` files (whole-module pickles) are detected and converted through
``io/reference_sav.py``, as the JAX loader does.  Unpickling runs
arbitrary code: load only checkpoints you trust.
"""

from __future__ import annotations

import importlib
import os
import pickle
import types

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


class _Ref:
    """A name the pickle resolves where it is loaded (``_Pickler``)."""


_ML_DTYPES, _BF16_TYPE, _BF16_DTYPE = _Ref(), _Ref(), _Ref()


class Bf16Bits:
    """A bf16 array as its raw bits (numpy uint16), pickled as the JAX
    package pickles an ``ml_dtypes.bfloat16`` array of those bits."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits, np.uint16)


class _Pickler(pickle.Pickler):
    """``pickle.Pickler`` that writes ``Bf16Bits`` as
    ``numpy.ndarray(shape, numpy.dtype(getattr(importlib.import_module(
    "ml_dtypes"), "bfloat16")), raw bytes)``: the reader imports
    ``ml_dtypes``, the writer never does."""

    def reducer_override(self, obj):
        if isinstance(obj, Bf16Bits):
            return np.ndarray, (obj.bits.shape, _BF16_DTYPE,
                                obj.bits.tobytes())
        if obj is _BF16_DTYPE:
            return np.dtype, (_BF16_TYPE,)
        if obj is _BF16_TYPE:
            return getattr, (_ML_DTYPES, "bfloat16")
        if obj is _ML_DTYPES:
            return importlib.import_module, ("ml_dtypes",)
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that reads ``ml_dtypes.bfloat16`` arrays (the
    JAX package's, and ``_Pickler``'s) as their uint16 bits, without
    ``ml_dtypes``; ``saw_bf16`` says whether it met one."""

    saw_bf16 = False

    def _bits_module(self, name: str):
        if name != "ml_dtypes":
            raise pickle.UnpicklingError(f"a checkpoint may not import "
                                         f"{name!r}")
        self.saw_bf16 = True
        return types.SimpleNamespace(bfloat16=np.uint16)

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            self.saw_bf16 = True
            return np.uint16
        if (module, name) == ("importlib", "import_module"):
            return self._bits_module
        return super().find_class(module, name)


def bf16_bits(a: np.ndarray) -> Bf16Bits:
    """The bits of a float32 array whose values are bf16 (the low halves
    zero), as ``Bf16Bits``."""
    a = np.ascontiguousarray(a, np.float32)
    return Bf16Bits((a.view(np.uint32) >> 16).astype(np.uint16))


def widen_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits as the float32 array of the same values."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16) \
        .view(np.float32)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def write_payload(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f).dump(payload)


def read_payload(path: str) -> tuple:
    """(the unpickled payload, whether it held bf16 arrays, which are
    uint16 bits in it)."""
    with open(path, "rb") as f:
        up = _Unpickler(f)
        payload = up.load()
    return payload, up.saw_bf16


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
    """``save_optimizer``'s payload, its arrays copied to the host: float32
    moments as float32 arrays, bf16 moments as ``Bf16Bits`` (the JAX
    package's bf16 arrays once written)."""
    from spatialvae_torch.train.optimizer import FusedAdamState

    if not isinstance(state, FusedAdamState):
        raise TypeError(f"not a FusedAdamState: {type(state).__name__}")
    dtypes = {t.dtype for t in (*state.mu.values(), *state.nu.values())}
    if not dtypes <= {torch.float32, torch.bfloat16} or len(dtypes) != 1:
        raise TypeError(f"Adam moments in {sorted(map(str, dtypes))}; "
                        f"expected all float32 or all bfloat16")

    def tree(moments):
        t = named_to_jax(q_net, p_net, moments)    # widened exactly
        return t if dtypes == {torch.float32} else _map_tree(t, bf16_bits)

    return {
        "format": FORMAT,
        "kind": "optimizer",
        "epoch": int(epoch),
        "count": int(state.count),
        "mu": tree(state.mu),
        "nu": tree(state.nu),
    }


def load_optimizer(path: str, q_net, p_net, device=None):
    """Returns (FusedAdamState, epoch), the moments on ``device`` in the
    file's dtype, float32 or bf16."""
    from spatialvae_torch.train.optimizer import FusedAdamState

    payload, bf16 = read_payload(path)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT \
            or payload.get("kind") != "optimizer":
        raise ValueError(f"{path} is not a {FORMAT} optimizer checkpoint")

    def named(tree):
        if not bf16:
            return named_from_jax(tree, q_net, p_net, device)
        f = _map_tree(tree, widen_bf16_bits)
        return {k: t.to(torch.bfloat16) for k, t in
                named_from_jax(f, q_net, p_net, device).items()}

    state = FusedAdamState(count=int(payload["count"]),
                           mu=named(payload["mu"]), nu=named(payload["nu"]))
    return state, int(payload["epoch"])
