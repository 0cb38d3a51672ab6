"""Weight bridge between the JAX package's param trees and the port's modules.

JAX stores every dense weight as (fan_in, fan_out) and a bilinear weight as
(in1, in2, out); the port's modules keep torch's (out, in) and
(out, in1, in2).  The trees are the ones the JAX models build and its
checkpoints pickle:

    generator: {"coord": {"w", "b"}, "latent": {"w"}, "bilinear": {"w"},
                "layers": [{"w", "b"}, ...]}       # hidden layers, then head
    inference: {"layers": [{"w", "b"}, ...]}

Leaves are numpy arrays (or anything ``np.asarray`` takes).  Every shape is
checked against the config; a mismatch raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from spatialvae_tpu.core.config import (
    InferenceConfig,
    SpatialGeneratorConfig,
    VanillaGeneratorConfig,
)
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.models.spatial import SpatialGenerator
from spatialvae_torch.nn.layers import stack_linears


def _load(dst: torch.Tensor, src, name: str, transpose=None) -> None:
    a = np.asarray(src, dtype=np.float32)
    if transpose is not None:
        a = a.transpose(transpose)
    if tuple(a.shape) != tuple(dst.shape):
        want = tuple(dst.shape)
        if transpose is not None:
            want = tuple(want[i] for i in np.argsort(transpose))
        raise ValueError(f"{name}: JAX param has shape "
                         f"{tuple(np.asarray(src).shape)}, config expects "
                         f"{want}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(a)))


def _load_linears(linears: List[nn.Linear], layers, name: str) -> None:
    if len(layers) != len(linears):
        raise ValueError(f"{name}: JAX tree has {len(layers)} layers, "
                         f"config expects {len(linears)}")
    for i, (lin, p) in enumerate(zip(linears, layers)):
        _load(lin.weight, p["w"], f"{name}[{i}].w", (1, 0))
        if lin.bias is not None:
            _load(lin.bias, p["b"], f"{name}[{i}].b")
        elif "b" in p:
            raise ValueError(f"{name}[{i}] has a bias the config lacks")


def _empty(cls, cfg, device, dtype):
    # built on the meta device: no init draws, then storage on ``device``
    return cls(cfg, device="meta", dtype=dtype).to_empty(
        device=device if device is not None else "cpu")


def generator_from_jax(params: Dict, cfg, *, device=None,
                       dtype: torch.dtype = torch.float32) -> SpatialGenerator:
    if isinstance(cfg, VanillaGeneratorConfig):
        raise NotImplementedError(
            "the vanilla generator is not ported yet (ROADMAP Queue 1, M1)")
    if not isinstance(cfg, SpatialGeneratorConfig):
        raise TypeError(f"not a generator config: {cfg!r}")
    gen = _empty(SpatialGenerator, cfg, device, dtype)
    _load(gen.coord_linear.weight, params["coord"]["w"], "coord.w", (1, 0))
    _load(gen.coord_linear.bias, params["coord"]["b"], "coord.b")
    if cfg.latent_dim > 0:
        _load(gen.latent_linear.weight, params["latent"]["w"], "latent.w",
              (1, 0))
        if cfg.bilinear:
            _load(gen.bilinear.weight, params["bilinear"]["w"],
                  "bilinear.w", (2, 0, 1))
    _load_linears(gen.linears(), params["layers"], "layers")
    return gen


def inference_from_jax(params: Dict, cfg: InferenceConfig, *, device=None,
                       dtype: torch.dtype = torch.float32
                       ) -> InferenceNetwork:
    net = _empty(InferenceNetwork, cfg, device, dtype)
    _load_linears(stack_linears(net.layers), params["layers"], "layers")
    return net


def from_jax_params(q_params: Dict, p_params: Dict, q_cfg: InferenceConfig,
                    p_cfg, device=None, dtype: torch.dtype = torch.float32
                    ) -> Tuple[InferenceNetwork, SpatialGenerator]:
    """JAX (q, p) param trees -> the port's (InferenceNetwork,
    SpatialGenerator) on ``device`` in ``dtype``."""
    return (inference_from_jax(q_params, q_cfg, device=device, dtype=dtype),
            generator_from_jax(p_params, p_cfg, device=device, dtype=dtype))


def _np(t: torch.Tensor, transpose=None) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a.transpose(transpose)
                                if transpose is not None else a)


def _dump_linears(linears: List[nn.Linear]) -> List[Dict]:
    out = []
    for lin in linears:
        p = {"w": _np(lin.weight, (1, 0))}
        if lin.bias is not None:
            p["b"] = _np(lin.bias)
        out.append(p)
    return out


def generator_to_jax(gen: SpatialGenerator) -> Dict:
    params = {"coord": {"w": _np(gen.coord_linear.weight, (1, 0)),
                        "b": _np(gen.coord_linear.bias)},
              "layers": _dump_linears(gen.linears())}
    if gen.latent_dim > 0:
        params["latent"] = {"w": _np(gen.latent_linear.weight, (1, 0))}
        if gen.cfg.bilinear:
            params["bilinear"] = {"w": _np(gen.bilinear.weight, (1, 2, 0))}
    return params


def inference_to_jax(net: InferenceNetwork) -> Dict:
    return {"layers": _dump_linears(stack_linears(net.layers))}


def to_jax_params(q_net: InferenceNetwork, p_net: SpatialGenerator
                  ) -> Tuple[Dict, Dict]:
    """Inverse of ``from_jax_params``: float32 numpy trees in the JAX
    package's (fan_in, fan_out) layout."""
    return inference_to_jax(q_net), generator_to_jax(p_net)
