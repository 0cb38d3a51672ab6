"""Adam with the JAX package's numerics — counterpart of
``spatialvae_tpu/train/optimizer.py`` (``fused_adam``, ``adam_leaf``,
``moments_dtype``).

The op order is the JAX one, op for op, so the port matches it to an ulp
where ``torch.optim.Adam`` (which orders its ops differently) does not:

    m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*(g*g)
    p += -lr * (m'/c1) / (sqrt(v'/c2) + eps),  c_i = 1 - b_i**count (f32)

Leaves are dicts of parameter name -> tensor; a step updates every leaf in
place in one launch of the step kernel (``kernels/adam.py``
``adam_step``) on the card, and through its plain version on the CPU.  The
moments are float32, or bfloat16 under ``SPATIALVAE_ADAM_MOMENTS=bf16``
(widened, updated in float32 and rounded once on store, as ``adam_leaf``
does).  ``train/optimizer_fused.py`` adds the shadow and int8 emission of
the JAX package's ``fused_adam_pallas``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from spatialvae_torch.kernels.adam import AdamConsts, adam_step
from spatialvae_torch.kernels.config import moments_dtype

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam", "moments_dtype"]


@dataclass
class FusedAdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class FusedAdam:
    """``fused_adam(lr, b1, b2, eps)``: ``init(params)`` and
    ``update_apply(grads, state, params)``, params and grads being dicts of
    name -> tensor with the same keys."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = (
            learning_rate, b1, b2, eps)

    def init(self, params: Dict[str, torch.Tensor]) -> FusedAdamState:
        """Zero moments in ``moments_dtype()``."""
        mdt = moments_dtype()
        zeros = {k: torch.zeros_like(p, dtype=mdt) for k, p in params.items()}
        return FusedAdamState(0, zeros,
                              {k: z.clone() for k, z in zeros.items()})

    def consts(self, count: int) -> AdamConsts:
        return AdamConsts.make(self.learning_rate, self.b1, self.b2,
                               self.eps, count)

    def update_apply(self, grads: Dict[str, torch.Tensor],
                     state: FusedAdamState,
                     params: Dict[str, torch.Tensor]) -> FusedAdamState:
        """Updates params, state.mu and state.nu in place (one launch of
        the step kernel); returns the state with the step count
        advanced."""
        count = state.count + 1
        adam_step([p.detach() for p in params.values()],
                  [grads[n] for n in params], [state.mu[n] for n in params],
                  [state.nu[n] for n in params], self.consts(count))
        return FusedAdamState(count, state.mu, state.nu)


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> FusedAdam:
    return FusedAdam(learning_rate, b1, b2, eps)
