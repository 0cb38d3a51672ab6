"""Torch-style textual reprs of the model architectures — counterpart of
``spatialvae_tpu/models/reprs.py``, byte for byte.

The reference writes ``print(model)`` (torch module reprs) into
``models.txt``; both packages write the same text, generated from the
configs, so a run's ``models.txt`` is the same whichever package trained
it.
"""

from __future__ import annotations

from spatialvae_torch.config import (
    InferenceConfig,
    SpatialGeneratorConfig,
    VanillaGeneratorConfig,
)

_ACT_REPR = {
    "tanh": "Tanh()",
    "relu": "ReLU()",
    "leakyrelu": "LeakyReLU(negative_slope=0.01)",
    "sigmoid": "Sigmoid()",
}


def _linear(n_in, n_out, bias=True):
    return f"Linear(in_features={n_in}, out_features={n_out}, bias={bias})"


def _resid(n, act):
    return ("ResidLinear(\n"
            f"      (linear): {_linear(n, n)}\n"
            f"      (act): {act}\n"
            "    )")


def _sequential(items, indent="  "):
    lines = [f"{indent}(layers): Sequential("]
    for i, item in enumerate(items):
        lines.append(f"{indent}  ({i}): {item}")
    lines.append(f"{indent})")
    return "\n".join(lines)


def torch_style_repr(cfg) -> str:
    if isinstance(cfg, InferenceConfig):
        act = _ACT_REPR[cfg.activation]
        items = [_linear(cfg.n, cfg.hidden_dim), act]
        for _ in range(1, cfg.num_layers):
            if cfg.resid:
                items.append(_resid(cfg.hidden_dim, act))
            else:
                items += [_linear(cfg.hidden_dim, cfg.hidden_dim), act]
        items.append(_linear(cfg.hidden_dim, 2 * cfg.latent_dim))
        return "InferenceNetwork(\n" + _sequential(items) + "\n)"

    if isinstance(cfg, SpatialGeneratorConfig):
        act = _ACT_REPR[cfg.activation]
        head = [f"  (coord_linear): {_linear(cfg.in_dim, cfg.hidden_dim)}"]
        if cfg.latent_dim > 0:
            head.append(
                f"  (latent_linear): "
                f"{_linear(cfg.latent_dim, cfg.hidden_dim, bias=False)}")
            if cfg.bilinear:
                head.append(
                    f"  (bilinear): Bilinear(in1_features={cfg.in_dim}, "
                    f"in2_features={cfg.latent_dim}, "
                    f"out_features={cfg.hidden_dim}, bias=False)")
        items = [act]
        for _ in range(1, cfg.num_layers):
            if cfg.resid:
                items.append(_resid(cfg.hidden_dim, act))
            else:
                items += [_linear(cfg.hidden_dim, cfg.hidden_dim), act]
        items += [_linear(cfg.hidden_dim, cfg.n_out), "Sigmoid()"]
        return ("SpatialGenerator(\n" + "\n".join(head) + "\n"
                + _sequential(items) + "\n)")

    if isinstance(cfg, VanillaGeneratorConfig):
        act = _ACT_REPR[cfg.activation]
        items = [_linear(cfg.latent_dim, cfg.hidden_dim), act]
        for _ in range(1, cfg.num_layers):
            if cfg.resid:
                items.append(_resid(cfg.hidden_dim, act))
            else:
                items += [_linear(cfg.hidden_dim, cfg.hidden_dim), act]
        items += [_linear(cfg.hidden_dim, cfg.n * cfg.n_out), "Sigmoid()"]
        if cfg.softplus:
            items.append("Softplus(beta=1.0, threshold=20.0)")
        return "VanillaGenerator(\n" + _sequential(items) + "\n)"

    raise TypeError(f"unknown config type {type(cfg)!r}")
