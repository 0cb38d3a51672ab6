"""The port's config built from the JAX package's through one dict: the JAX
``config_to_dict`` on one side and the port's ``config_from_dict`` on the
other, so a test hands each package its own config."""

from spatialvae_tpu.core import config as jax_config

from spatialvae_torch import config as port_config


def to_port(cfg):
    return port_config.config_from_dict(jax_config.config_to_dict(cfg))
