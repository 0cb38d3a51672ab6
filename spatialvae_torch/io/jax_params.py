"""Weight bridge between the JAX package's param trees and the port's modules.

JAX stores every dense weight as (fan_in, fan_out) and a bilinear weight as
(in1, in2, out); the port's modules keep torch's (out, in) and
(out, in1, in2).  The trees are the ones the JAX models build and its
checkpoints pickle:

    generator: {"coord": {"w", "b"}, "latent": {"w"}, "bilinear": {"w"},
                "layers": [{"w", "b"}, ...]}       # hidden layers, then head
    vanilla generator: {"layers": [{"w", "b"}, ...]}   # z -> ... -> head
    inference: {"layers": [{"w", "b"}, ...]}

Leaves are numpy arrays (or anything ``np.asarray`` takes).  Every shape is
checked against the config; a mismatch raises ``ValueError``.

Trees of other per-parameter tensors (Adam moments, gradients) map the same
way: the port keeps them as dicts of ``q.<name>``/``p.<name>`` -> tensor in
the module's layout (``named_to_jax``, ``named_from_jax``), the JAX package
as a ``{"q": ..., "p": ...}`` tree in its own.  ``state_from_jax`` carries a
whole JAX ``TrainState`` across: the masters, the Adam state (float32 or
bf16 moments), the bf16 shadow and the int8 qshadow.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spatialvae_torch.config import (
    InferenceConfig,
    SpatialGeneratorConfig,
    VanillaGeneratorConfig,
)
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.models.spatial import SpatialGenerator
from spatialvae_torch.models.vanilla import VanillaGenerator
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
                       dtype: torch.dtype = torch.float32):
    """A ``SpatialGenerator`` or, for a ``VanillaGeneratorConfig``, a
    ``VanillaGenerator``."""
    if isinstance(cfg, VanillaGeneratorConfig):
        gen = _empty(VanillaGenerator, cfg, device, dtype)
        _load_linears(gen.linears(), params["layers"], "layers")
        return gen
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
                    ) -> Tuple[InferenceNetwork, nn.Module]:
    """JAX (q, p) param trees -> the port's (InferenceNetwork,
    SpatialGenerator or VanillaGenerator) on ``device`` in ``dtype``."""
    return (inference_from_jax(q_params, q_cfg, device=device, dtype=dtype),
            generator_from_jax(p_params, p_cfg, device=device, dtype=dtype))


def _np(t: torch.Tensor, transpose=None) -> np.ndarray:
    """A float32 host copy of ``t`` (its axes in ``transpose`` order) that
    never shares the tensor's storage: a checkpoint pickles it while later
    optimizer steps write the parameters in place."""
    a = t.detach().to(torch.float32)
    if transpose is not None:
        a = a.permute(transpose)
    return a.to("cpu", memory_format=torch.contiguous_format,
                copy=True).numpy()


def _dump_linears(linears: List[nn.Linear]) -> List[Dict]:
    out = []
    for lin in linears:
        p = {"w": _np(lin.weight, (1, 0))}
        if lin.bias is not None:
            p["b"] = _np(lin.bias)
        out.append(p)
    return out


def generator_to_jax(gen) -> Dict:
    if isinstance(gen, VanillaGenerator):
        return {"layers": _dump_linears(gen.linears())}
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


def named_to_jax(q_net: InferenceNetwork, p_net: SpatialGenerator,
                 tensors: Dict[str, torch.Tensor]) -> Dict:
    """{"q": tree, "p": tree} in the JAX layout from a dict of
    ``q.<name>``/``p.<name>`` -> tensor shaped like that parameter."""
    out = {}
    for key, net, dump in (("q", q_net, inference_to_jax),
                           ("p", p_net, generator_to_jax)):
        twin = _empty(type(net), net.cfg, "cpu", torch.float32)
        twin.load_state_dict({n: tensors[f"{key}.{n}"].detach().float().cpu()
                              for n, _ in net.named_parameters()})
        out[key] = dump(twin)
    return out


def named_from_jax(tree: Dict, q_net: InferenceNetwork,
                   p_net: SpatialGenerator, device=None
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of ``named_to_jax``: float32 tensors on ``device`` keyed
    like the modules' parameters."""
    q = inference_from_jax(tree["q"], q_net.cfg, device=device)
    p = generator_from_jax(tree["p"], p_net.cfg, device=device)
    return {f"{key}.{n}": t.detach() for key, net in (("q", q), ("p", p))
            for n, t in net.named_parameters()}


def leaf_paths(q_net: InferenceNetwork, p_net: SpatialGenerator
               ) -> Dict[str, Tuple[tuple, Optional[tuple]]]:
    """``q.<name>``/``p.<name>`` -> (its path in the JAX {"q", "p"} tree,
    the permutation from the JAX array to the port tensor, or None)."""
    out = {}

    def add(key, net, param, path, perm):
        names = {id(t): n for n, t in net.named_parameters()}
        out[f"{key}.{names[id(param)]}"] = ((key,) + path, perm)

    def linears(key, net, lins):
        for i, lin in enumerate(lins):
            add(key, net, lin.weight, ("layers", i, "w"), (1, 0))
            if lin.bias is not None:
                add(key, net, lin.bias, ("layers", i, "b"), None)

    linears("q", q_net, stack_linears(q_net.layers))
    if isinstance(p_net, VanillaGenerator):
        linears("p", p_net, p_net.linears())
        return out
    add("p", p_net, p_net.coord_linear.weight, ("coord", "w"), (1, 0))
    add("p", p_net, p_net.coord_linear.bias, ("coord", "b"), None)
    if p_net.latent_dim > 0:
        add("p", p_net, p_net.latent_linear.weight, ("latent", "w"), (1, 0))
        if p_net.cfg.bilinear:
            add("p", p_net, p_net.bilinear.weight, ("bilinear", "w"),
                (2, 0, 1))
    linears("p", p_net, p_net.linears())
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tensor(a, perm, dtype, device) -> torch.Tensor:
    """A JAX array (bf16 included, widened exactly) as a port tensor."""
    src = np.asarray(a)
    f = np.asarray(src, dtype=np.float32)
    if perm is not None and f.size:
        f = f.transpose(perm)
    t = torch.from_numpy(np.ascontiguousarray(f))
    return t.to(device=device if device is not None else "cpu", dtype=dtype)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def _port_dtype(a) -> torch.dtype:
    name = str(np.asarray(a).dtype)
    if name not in _DTYPES:
        raise TypeError(f"no port dtype for a JAX {name} array")
    return _DTYPES[name]


def state_from_jax(state, q_net: InferenceNetwork, p_net: SpatialGenerator,
                   device=None) -> Dict:
    """A JAX ``TrainState`` as the port trainer's state: {"params": name ->
    float32 master, "opt_state": ``FusedAdamState`` (moments in their JAX
    dtype, float32 or bf16), "shadow": name -> bf16 leaf requiring grad, or
    None, "qshadow": name -> {"q" int8 in the port's layout, "s", "ns"
    (1, 1) float32}, or None}.  Load "params" into the modules with
    ``load_named``; the rest are the trainer's ``opt_state``, ``shadow``
    and ``qshadow``."""
    from spatialvae_torch.train.optimizer import FusedAdamState

    paths = leaf_paths(q_net, p_net)

    def named(tree, dtype=None):
        return {n: _tensor(_get(tree, path), perm,
                           dtype or _port_dtype(_get(tree, path)), device)
                for n, (path, perm) in paths.items()}

    out = {"params": named(state.params, torch.float32),
           "opt_state": FusedAdamState(int(state.opt_state.count),
                                       named(state.opt_state.mu),
                                       named(state.opt_state.nu)),
           "shadow": None, "qshadow": None}
    if getattr(state, "shadow", None) is not None:
        out["shadow"] = {n: t.requires_grad_() for n, t in
                         named(state.shadow).items()}
    if getattr(state, "qshadow", None) is not None:
        out["qshadow"] = {}
        for n, (path, perm) in paths.items():
            e = _get(state.qshadow, path)
            out["qshadow"][n] = {
                "q": _tensor(e["q"], perm, torch.int8, device),
                "s": _tensor(e["s"], None, torch.float32, device),
                "ns": _tensor(e["ns"], None, torch.float32, device)}
    return out


def load_named(q_net: InferenceNetwork, p_net: SpatialGenerator,
               tensors: Dict[str, torch.Tensor]) -> None:
    """Copy ``q.<name>``/``p.<name>`` tensors into the modules' parameters."""
    with torch.no_grad():
        for key, net in (("q", q_net), ("p", p_net)):
            for n, p in net.named_parameters():
                p.copy_(tensors[f"{key}.{n}"])
