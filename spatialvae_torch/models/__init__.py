from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    can_fold,
    fold_pose_into_first_layer,
    spatial_generator_apply_folded,
)
from spatialvae_torch.models.vanilla import VanillaGenerator

__all__ = [
    "InferenceNetwork",
    "SpatialGenerator",
    "can_fold",
    "fold_pose_into_first_layer",
    "spatial_generator_apply_folded",
    "VanillaGenerator",
]
