"""Layers in the reference's ``nn.Module`` layout.

Counterpart of ``spatialvae_tpu/nn/layers.py``.  Where the JAX package keeps
(fan_in, fan_out) param trees, the port keeps the reference's own modules
(``nn.Linear`` weights are (out, in)), built in the same ``nn.Sequential``
order as the reference networks, so a port module's ``state_dict`` is the
reference module's and ``spatialvae_tpu/io/torch_import.py`` describes both.

Initialisation is torch's ``nn.Linear``/``nn.Bilinear`` default (weight and
bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn from an explicit
``torch.Generator`` so a seed fixes every weight.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

# The reference maps CLI names to torch modules per trainer (see the JAX
# package's table); 'leakyrelu' is torch's default negative slope 0.01.
ACTIVATIONS = {
    "tanh": nn.Tanh,
    "relu": nn.ReLU,
    "leakyrelu": nn.LeakyReLU,
    "sigmoid": nn.Sigmoid,
}


def resolve_activation(name: str) -> nn.Module:
    """A fresh activation module by canonical name."""
    try:
        return ACTIVATIONS[name]()
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; expected one of {sorted(ACTIVATIONS)}"
        ) from None


def _device(device):
    # skip_init keeps a module on the meta device when handed device=None
    return torch.get_default_device() if device is None else device


def _uniform_(t: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        nn.init.uniform_(t, -bound, bound, generator=generator)


def linear(n_in: int, n_out: int, *, bias: bool = True,
           generator: Optional[torch.Generator] = None, device=None,
           dtype: torch.dtype = torch.float32) -> nn.Linear:
    """``nn.Linear`` with torch's default init drawn from ``generator``."""
    lin = nn.utils.skip_init(nn.Linear, n_in, n_out, bias=bias,
                             device=_device(device), dtype=dtype)
    bound = 1.0 / math.sqrt(n_in)
    _uniform_(lin.weight, bound, generator)
    if bias:
        _uniform_(lin.bias, bound, generator)
    return lin


def bilinear(n_in1: int, n_in2: int, n_out: int, *,
             generator: Optional[torch.Generator] = None, device=None,
             dtype: torch.dtype = torch.float32) -> nn.Bilinear:
    """Bias-free ``nn.Bilinear`` (the reference always builds it so)."""
    bl = nn.utils.skip_init(nn.Bilinear, n_in1, n_in2, n_out, bias=False,
                            device=_device(device), dtype=dtype)
    _uniform_(bl.weight, 1.0 / math.sqrt(n_in1), generator)
    return bl


class ResidLinear(nn.Module):
    """``act(linear(x) + x)`` — the reference's ResidLinear."""

    def __init__(self, n: int, activation: str, **kw):
        super().__init__()
        self.linear = linear(n, n, **kw)
        self.act = resolve_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.linear(x) + x)


def hidden_layer(n: int, activation: str, resid: bool, **kw
                 ) -> List[nn.Module]:
    """One hidden->hidden layer: ``[ResidLinear]`` or ``[Linear, act]``."""
    if resid:
        return [ResidLinear(n, activation, **kw)]
    return [linear(n, n, **kw), resolve_activation(activation)]


def mlp(dims: Sequence[int], activation: str, resid_hidden: bool = False,
        **kw) -> nn.Sequential:
    """``[Linear, act] * (n-1), Linear`` over ``dims = [in, h, ..., h, out]``.

    Hidden->hidden layers become residual when ``resid_hidden``; the first
    layer never is, because its input width differs (the JAX package's
    ``mlp_apply`` rule).  ``kw`` carries ``generator``/``device``/``dtype``.
    """
    mods: List[nn.Module] = []
    for i in range(len(dims) - 2):
        if i == 0:
            mods += [linear(dims[0], dims[1], **kw),
                     resolve_activation(activation)]
        elif dims[i] != dims[i + 1]:
            raise ValueError(f"hidden widths must match, got {list(dims)}")
        else:
            mods += hidden_layer(dims[i], activation, resid_hidden, **kw)
    mods.append(linear(dims[-2], dims[-1], **kw))
    return nn.Sequential(*mods)


def stack_linears(seq: nn.Sequential) -> List[nn.Linear]:
    """The ``nn.Linear``s of a reference-layout stack, in order
    (a ResidLinear contributes its inner ``.linear``)."""
    out = []
    for m in seq.children():
        if isinstance(m, ResidLinear):
            out.append(m.linear)
        elif isinstance(m, nn.Linear):
            out.append(m)
    return out
