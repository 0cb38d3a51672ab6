from spatialvae_torch.data.dataset import ArrayDataset

__all__ = ["ArrayDataset"]
