from spatialvae_torch.objectives.elbo import (
    ElboConfig,
    decode,
    decode_spatial,
    elbo_minibatch,
    fused_loss_active,
    loss_and_grad,
    loss_terms,
)

__all__ = ["ElboConfig", "decode", "decode_spatial", "elbo_minibatch",
           "fused_loss_active", "loss_and_grad", "loss_terms"]
