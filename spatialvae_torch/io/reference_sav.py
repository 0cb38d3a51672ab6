"""Read and write the reference implementation's checkpoints (torch
whole-module pickles, ``{prefix}_generator_epoch{E}.sav`` and
``{prefix}_inference_epoch{E}.sav``): reading gives the port's (params,
config, kind), writing takes them.

The port's own copy of ``spatialvae_tpu/io/torch_import.py``: the reading
half (``load_torch_module``, ``import_module`` and the walkers they call)
and the writing half (``export_generator``, ``export_inference``, for users
whose downstream analysis ``torch.load``s the reference's modules;
``tools/export_torch_checkpoint.py`` converts saved checkpoints), with the
same conversion rules:

- torch ``nn.Linear`` stores (fan_out, fan_in); the params tree stores the
  transpose (fan_in, fan_out);
- torch ``nn.Bilinear`` stores (out, in1, in2); the tree (in1, in2, out);
- the architecture (hidden_dim, num_layers, resid, expand_coords,
  softplus, activation, ...) is recovered from the module structure.

Unpickling a whole module needs the classes it was built from.  If the
reference package ``spatial_vae`` is importable it is used; otherwise
stand-in classes with the same qualified names are registered while the
file loads (``nn.Module`` restores its state by plain attribute
assignment, so no reference code is needed).  An exported file pickles the
reference's class names, so it loads, and runs forward, wherever the
reference package is installed, and loads back here without it.
Unpickling runs arbitrary code: load only files you trust.
"""

from __future__ import annotations

import contextlib
import sys
import types

import numpy as np
import torch

from spatialvae_torch.config import (
    InferenceConfig,
    SpatialGeneratorConfig,
    VanillaGeneratorConfig,
)

_REF_CLASSES = ("InferenceNetwork", "SpatialGenerator", "VanillaGenerator",
                "ResidLinear")


@contextlib.contextmanager
def _reference_classes():
    """Make ``spatial_vae.models.*`` resolvable for the unpickler while the
    context is active, leaving nothing behind: stand-ins are removed from
    ``sys.modules`` on exit, so they never shadow a real ``spatial_vae``
    put on the path later.  Reentrant."""
    try:
        import spatial_vae.models  # noqa: F401
        yield
        return
    except ImportError:
        pass
    if "spatial_vae.models" in sys.modules:
        yield
        return
    pkg = types.ModuleType("spatial_vae")
    mod = types.ModuleType("spatial_vae.models")
    for name in _REF_CLASSES:
        cls = type(name, (torch.nn.Module,),
                   {"__module__": "spatial_vae.models"})
        setattr(mod, name, cls)
    pkg.models = mod
    sys.modules["spatial_vae"] = pkg
    sys.modules["spatial_vae.models"] = mod
    try:
        yield
    finally:
        if sys.modules.get("spatial_vae.models") is mod:
            del sys.modules["spatial_vae.models"]
        if sys.modules.get("spatial_vae") is pkg:
            del sys.modules["spatial_vae"]


def load_torch_module(path: str):
    """torch.load a reference .sav (whole-module pickle) on the CPU."""
    with _reference_classes():
        return torch.load(path, map_location="cpu", weights_only=False)


def _w(linear) -> np.ndarray:
    return np.asarray(linear.weight.detach(), dtype=np.float32).T


def _linear_params(linear) -> dict:
    p = {"w": _w(linear)}
    if getattr(linear, "bias", None) is not None:
        p["b"] = np.asarray(linear.bias.detach(), dtype=np.float32)
    return p


def _act_names():
    nn = torch.nn
    return {nn.Tanh: "tanh", nn.LeakyReLU: "leakyrelu",
            nn.ReLU: "relu", nn.Sigmoid: "sigmoid"}


def _walk_stack(seq):
    """(linears, resid, activation_name) from a reference layer
    ``nn.Sequential``.  A ResidLinear contributes its inner ``.linear``.
    The hidden activation is the first activation before the last Linear,
    never the trailing output head."""
    names = _act_names()
    children = list(seq.children())
    linears, resid, acts = [], False, []
    for i, m in enumerate(children):
        if isinstance(m, torch.nn.Linear):
            linears.append((i, m))
        elif type(m).__name__ == "ResidLinear":
            linears.append((i, m.linear))
            resid = True
            inner = getattr(m, "act", None)
            if inner is not None and type(inner) in names:
                acts.append((i, names[type(inner)]))
        elif type(m) in names:
            acts.append((i, names[type(m)]))
    last_linear = linears[-1][0]
    act = next((name for i, name in acts if i < last_linear), None)
    return [m for _, m in linears], resid, (act or "tanh")


def _hidden_act(seq):
    """Hidden activation of a SpatialGenerator stack: its first module, the
    activation applied to the summed first-layer terms."""
    first = next(iter(seq.children()))
    return _act_names().get(type(first), "tanh")


def _import_inference(q_net):
    linears, resid, act = _walk_stack(q_net.layers)
    n = linears[0].in_features
    hidden = linears[0].out_features
    out = linears[-1].out_features
    latent = int(getattr(q_net, "latent_dim", out // 2))
    if out != 2 * latent:
        raise ValueError(
            f"inference head emits {out} features, expected 2*latent_dim="
            f"{2 * latent}")
    cfg = InferenceConfig(n=int(n), latent_dim=latent,
                          hidden_dim=int(hidden),
                          num_layers=len(linears) - 1,
                          activation=act, resid=resid)
    return {"layers": [_linear_params(m) for m in linears]}, cfg


def _import_spatial_generator(p_net):
    coord = p_net.coord_linear
    in_dim = coord.in_features
    latent_lin = getattr(p_net, "latent_linear", None)
    bilinear = getattr(p_net, "bilinear", None)
    linears, resid, _ = _walk_stack(p_net.layers)
    head = linears[-1]
    cfg = SpatialGeneratorConfig(
        latent_dim=int(latent_lin.in_features) if latent_lin is not None
        else 0,
        hidden_dim=int(coord.out_features),
        n_out=int(head.out_features),
        num_layers=len(linears),
        activation=_hidden_act(p_net.layers),
        softplus=bool(getattr(p_net, "softplus", False)),
        resid=resid,
        expand_coords=bool(getattr(p_net, "expand_coords", in_dim == 5)),
        bilinear=bilinear is not None,
    )
    params = {"coord": _linear_params(coord),
              "layers": [_linear_params(m) for m in linears]}
    if latent_lin is not None:
        params["latent"] = {"w": _w(latent_lin)}
        if bilinear is not None:
            params["bilinear"] = {"w": np.asarray(
                bilinear.weight.detach(), dtype=np.float32
            ).transpose(1, 2, 0)}
    return params, cfg


def _import_vanilla_generator(p_net):
    linears, resid, act = _walk_stack(p_net.layers)
    n_out = int(getattr(p_net, "n_out", 1))
    cfg = VanillaGeneratorConfig(
        n=int(linears[-1].out_features) // n_out,
        latent_dim=int(linears[0].in_features),
        hidden_dim=int(linears[0].out_features),
        n_out=n_out,
        num_layers=len(linears) - 1,
        activation=act,
        softplus=bool(getattr(p_net, "softplus", False)),
        resid=resid,
    )
    return {"layers": [_linear_params(m) for m in linears]}, cfg


def import_module(module):
    """(params, cfg, kind) for any of the three reference networks,
    dispatched on the module's structure."""
    if "coord_linear" in getattr(module, "_modules", {}):
        params, cfg = _import_spatial_generator(module)
        return params, cfg, "generator"
    if hasattr(module, "n_out"):                     # VanillaGenerator
        params, cfg = _import_vanilla_generator(module)
        return params, cfg, "generator"
    params, cfg = _import_inference(module)
    return params, cfg, "inference"


# ---------------------------------------------------------------------------
# export: (params, cfg) -> the reference's module pickles
# ---------------------------------------------------------------------------


def _classes() -> dict:
    """The classes to pickle against, inside an active
    ``_reference_classes`` context that spans the save (pickle resolves
    them through ``sys.modules`` then): the reference package's when it is
    importable, the stand-ins otherwise."""
    import spatial_vae.models as m

    return {name: getattr(m, name) for name in _REF_CLASSES}


def _blank_module(cls):
    """An instance of ``cls`` with ``nn.Module``'s plumbing, without the
    reference's ``__init__`` (which wants its arguments and prints)."""
    obj = cls.__new__(cls)
    torch.nn.Module.__init__(obj)
    return obj


def _torch_linear(p: dict) -> torch.nn.Linear:
    w = np.asarray(p["w"], dtype=np.float32)
    lin = torch.nn.Linear(w.shape[0], w.shape[1], bias="b" in p)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
        if "b" in p:
            lin.bias.copy_(torch.from_numpy(
                np.asarray(p["b"], dtype=np.float32)))
    return lin


def _torch_act(name: str) -> torch.nn.Module:
    nn = torch.nn
    return {"tanh": nn.Tanh, "leakyrelu": nn.LeakyReLU, "relu": nn.ReLU,
            "sigmoid": nn.Sigmoid}[name]()


def _torch_stack(layers, cfg, classes, head_modules) -> torch.nn.Sequential:
    """The hidden [Linear or ResidLinear, activation] stack, the head
    Linear and the trailing modules, in the reference's Sequential
    layout."""
    mods = []
    for p in layers[:-1]:
        if cfg.resid:
            r = _blank_module(classes["ResidLinear"])
            r.linear = _torch_linear(p)
            r.act = _torch_act(cfg.activation)
            mods.append(r)
        else:
            mods.extend([_torch_linear(p), _torch_act(cfg.activation)])
    mods.append(_torch_linear(layers[-1]))
    mods.extend(head_modules)
    return torch.nn.Sequential(*mods)


def _generator_module(params, cfg, classes):
    if isinstance(cfg, VanillaGeneratorConfig):
        net = _blank_module(classes["VanillaGenerator"])
        net.n_out = cfg.n_out
        net.softplus = cfg.softplus
        head = [torch.nn.Sigmoid()]
        if cfg.softplus:
            head.append(torch.nn.Softplus())
        # the first layer is always a plain Linear and its activation; only
        # the later hidden layers take the resid form
        layers = params["layers"]
        stack = _torch_stack(layers[1:], cfg, classes, head)
        net.layers = torch.nn.Sequential(
            _torch_linear(layers[0]), _torch_act(cfg.activation),
            *stack.children())
        return net.eval()
    net = _blank_module(classes["SpatialGenerator"])
    net.softplus = cfg.softplus
    net.expand_coords = cfg.expand_coords
    net.latent_dim = cfg.latent_dim
    net.coord_linear = _torch_linear(params["coord"])
    if cfg.latent_dim > 0:
        net.latent_linear = _torch_linear(params["latent"])
        if cfg.bilinear:
            w = np.asarray(params["bilinear"]["w"], dtype=np.float32)
            bl = torch.nn.Bilinear(w.shape[0], w.shape[1], w.shape[2],
                                   bias=False)
            with torch.no_grad():
                bl.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(w.transpose(2, 0, 1))))
            net.bilinear = bl
    # layers = [activation] + the hidden stack + the head + Sigmoid
    stack = _torch_stack(params["layers"], cfg, classes, [torch.nn.Sigmoid()])
    net.layers = torch.nn.Sequential(_torch_act(cfg.activation),
                                     *stack.children())
    return net.eval()


def _inference_module(params, cfg: InferenceConfig, classes):
    net = _blank_module(classes["InferenceNetwork"])
    net.latent_dim = cfg.latent_dim
    net.n = cfg.n
    layers = params["layers"]
    stack = _torch_stack(layers[1:], cfg, classes, [])
    net.layers = torch.nn.Sequential(
        _torch_linear(layers[0]), _torch_act(cfg.activation),
        *stack.children())
    return net.eval()


def export_generator(params, cfg, path: str) -> None:
    """Write a reference-format generator ``.sav`` (a torch module pickle)
    from a (fan_in, fan_out) params tree and its spatial or vanilla
    generator config.  One ``_reference_classes`` context spans the build
    and the save: pickle checks the classes' identity when it saves."""
    with _reference_classes():
        torch.save(_generator_module(params, cfg, _classes()), path)


def export_inference(params, cfg: InferenceConfig, path: str) -> None:
    """Write a reference-format inference ``.sav`` (a torch module
    pickle)."""
    with _reference_classes():
        torch.save(_inference_module(params, cfg, _classes()), path)
