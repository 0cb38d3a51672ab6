"""Dataset evaluation — counterpart of the host-resident branch of the JAX
package's ``Trainer.eval_epoch``: full batches in order plus a trailing
partial batch, each through the ELBO, averaged per image (batch-size
weighted, as ``StreamingMeans`` does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spatialvae_torch.objectives.elbo import elbo_minibatch


def eval_batches(model, images, batch_size: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[float, float, float]:
    """model: a ``SpatialVae``; images: (N, HW[, C]) in [0, 1] (tensor or
    numpy).  Returns the per-image means (elbo, log_p, kl)."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    ecfg = model.serving_ecfg
    count = 0
    means = [0.0, 0.0, 0.0]
    for i in range(0, len(images), batch_size):
        y = model.as_tensor(images[i:i + batch_size])
        b = y.shape[0]
        elbo, log_p, kl, _ = elbo_minibatch(
            model.q_net, model.p_net, ecfg, model.coords, y, generator)
        count += b
        for j, v in enumerate((elbo, log_p, kl)):
            means[j] += b * (float(v) - means[j]) / count
    return means[0], means[1], means[2]
