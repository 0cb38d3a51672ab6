from spatialvae_torch.ctf.apply import apply_ctf, apply_ctf_spatial
from spatialvae_torch.ctf.physics import compute_2d_ctf, ctf_filter, parse_ctf

__all__ = [
    "compute_2d_ctf",
    "ctf_filter",
    "parse_ctf",
    "apply_ctf",
    "apply_ctf_spatial",
]
