"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips without one.  The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit, without the JAX
test configuration:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The JAX parity of the plain versions is in ``test_torch_port_decoder.py``.
"""

import math

import pytest
import torch

from spatialvae_tpu.core.config import SpatialGeneratorConfig

from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.models import SpatialGenerator
from spatialvae_torch.transforms.coords import coord_grid

pytestmark = pytest.mark.cuda

# limits on the largest and the mean absolute error, as in chip_smoke.py
TOL = {torch.float32: (5e-6, 1e-6), torch.bfloat16: (5e-4, 1e-5)}

# (Lh, resid, No, weight dtype, HW)
CASES = [
    (1, False, 3, torch.float32, 4096),
    (1, False, 3, torch.bfloat16, 4096),
    (1, True, 1, torch.float32, 784),
    (2, False, 8, torch.float32, 1600),
    (2, True, 3, torch.bfloat16, 784),
    (3, True, 8, torch.float32, 4096),
    (4, False, 1, torch.bfloat16, 256),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(lh, no, hw, wdt, device, b=5, h=500, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, bound):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound

    side = math.isqrt(hw)
    fold = torch.zeros((b, 4, h), device=device)
    fold[:, :2] = u(b, 2, h, bound=0.7)
    fold[:, 2] = u(b, h, bound=1.5)
    bound = 1 / math.sqrt(h)
    return [fold, coord_grid(side, side, device=device)] + [
        u(*s, bound=bound).to(wdt)
        for s in ((lh, h, h), (lh, h), (no, h), (no,))]


def _assert_close(got, want, wdt):
    d = (got - want).abs()
    assert d.max().item() <= TOL[wdt][0]
    assert d.mean().item() <= TOL[wdt][1]


def _case_id(c):
    lh, resid, no, wdt, hw = c
    return (f"Lh{lh}-{'resid' if resid else 'plain'}-No{no}-"
            f"{str(wdt)[6:]}-HW{hw}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_plain_version(case, cuda_device):
    lh, resid, no, wdt, hw = case
    args = _inputs(lh, no, hw, wdt, cuda_device)
    before = fd.fused_decoder_tail.launches
    with torch.no_grad():
        got = fd.fused_decoder_tail(*args, resid)
        torch.cuda.synchronize()
        want = fd.decoder_tail_reference(*args, resid)
    assert fd.fused_decoder_tail.launches == before + 1
    assert got.shape == (5, no, hw)
    _assert_close(got, want, wdt)


def test_kernel_at_max_hidden(cuda_device):
    """The widest hidden layer the kernel's shared memory takes."""
    from spatialvae_torch.kernels._build import load_library

    assert load_library().svt_fused_decoder_max_hidden() == fd.MAX_HIDDEN
    args = _inputs(2, 3, 784, torch.float32, cuda_device, h=fd.MAX_HIDDEN)
    with torch.no_grad():
        got = fd.fused_decoder_tail(*args, True)
        want = fd.decoder_tail_reference(*args, True)
    _assert_close(got, want, torch.float32)


def test_fused_generator_runs_kernel(cuda_device):
    cfg = SpatialGeneratorConfig(latent_dim=4, hidden_dim=500, n_out=3,
                                 num_layers=2, softplus=True)
    gen = SpatialGenerator(cfg, generator=torch.Generator().manual_seed(1))
    gen_cuda = SpatialGenerator(cfg, device=cuda_device)
    gen_cuda.load_state_dict(gen.state_dict())
    z = torch.randn((4, 4), generator=torch.Generator().manual_seed(2))
    before = fd.fused_decoder_tail.launches
    with torch.no_grad():
        got = fd.fused_spatial_generator(
            gen_cuda, coord_grid(64, 64, device=cuda_device), None, None,
            z.to(cuda_device))
        want = fd.fused_spatial_generator(gen, coord_grid(64, 64), None,
                                          None, z)
    assert fd.fused_decoder_tail.launches == before + 1
    _assert_close(got.cpu(), want, torch.float32)


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    args = _inputs(1, 3, 256, torch.float32, cuda_device)
    args[2] = args[2].half()
    with pytest.raises(TypeError):
        fd.fused_decoder_tail(*args)
    args = _inputs(1, 3, 256, torch.float32, cuda_device)
    args[0] = args[0].cpu()
    with pytest.raises(ValueError, match="several devices"):
        fd.fused_decoder_tail(*args)
