from spatialvae_torch.objectives.elbo import (
    ElboConfig,
    decode_spatial,
    elbo_minibatch,
)

__all__ = ["ElboConfig", "decode_spatial", "elbo_minibatch"]
