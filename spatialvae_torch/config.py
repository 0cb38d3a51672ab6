"""Static model configuration dataclasses of the port.

The port's own copy of ``spatialvae_tpu/core/config.py``: the same three
frozen dataclasses with the same fields and defaults, and the same dict
form (``config_to_dict`` / ``config_from_dict``), so a checkpoint written
by either package loads in the other.  ``ElboConfig`` lives in
``objectives/elbo.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class InferenceConfig:
    """q(z|y): flat image -> (z_mu, z_logstd)."""

    n: int                      # input size = pixels * channels
    latent_dim: int             # inf_dim = z + rotate + 2*translate
    hidden_dim: int = 500
    num_layers: int = 1
    activation: str = "tanh"
    resid: bool = False


@dataclass(frozen=True)
class SpatialGeneratorConfig:
    """p(y|x,z): per-coordinate MLP decoder."""

    latent_dim: int
    hidden_dim: int = 500
    n_out: int = 1
    num_layers: int = 1
    activation: str = "tanh"
    softplus: bool = False
    resid: bool = False
    expand_coords: bool = False
    bilinear: bool = False

    @property
    def in_dim(self) -> int:
        # expand_coords appends x^2, y^2, x*y
        return 5 if self.expand_coords else 2


@dataclass(frozen=True)
class VanillaGeneratorConfig:
    """Standard MLP decoder z -> all pixels at once."""

    n: int                      # number of pixels
    latent_dim: int
    hidden_dim: int = 500
    n_out: int = 1
    num_layers: int = 1
    activation: str = "tanh"
    softplus: bool = False
    resid: bool = False


def config_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["__class__"] = type(cfg).__name__
    return d


def config_from_dict(d: dict):
    """Config dataclass from its dict form; an ``ElboConfig`` is built as the
    port's own, dropping fields it does not know."""
    d = dict(d)
    name = d.pop("__class__")
    if name == "ElboConfig":
        # lazy import: objectives depends on this module
        from spatialvae_torch.objectives.elbo import ElboConfig
        known = {f.name for f in dataclasses.fields(ElboConfig)}
        return ElboConfig(**{k: v for k, v in d.items() if k in known})
    cls = {
        "InferenceConfig": InferenceConfig,
        "SpatialGeneratorConfig": SpatialGeneratorConfig,
        "VanillaGeneratorConfig": VanillaGeneratorConfig,
    }[name]
    return cls(**d)
