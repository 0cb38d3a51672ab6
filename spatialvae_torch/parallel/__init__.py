"""Training on a mesh of ranks over ``torch.distributed`` — counterpart of
``spatialvae_tpu/parallel/``: the mesh (``mesh.py``), what each rank holds
(``sharding.py``), the pixel-sharded loss kernel (``pixel.py``), the mesh's
steps (``spmd.py``), the collectives (``collectives.py``) and the CPU
dry run (``dryrun.py``)."""

from spatialvae_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    create_mesh,
    init_world,
    initialize_multihost,
)
from spatialvae_torch.parallel.pixel import (
    can_pixel_shard,
    make_pixel_sharded_loss,
)
from spatialvae_torch.parallel.sharding import (
    batch_sharding,
    param_shardings,
    replicated,
    shard_params,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "create_mesh",
    "init_world",
    "initialize_multihost",
    "batch_sharding",
    "param_shardings",
    "replicated",
    "shard_params",
    "can_pixel_shard",
    "make_pixel_sharded_loss",
]
