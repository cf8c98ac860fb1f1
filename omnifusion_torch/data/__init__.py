from omnifusion_torch.data.datasets import SyntheticDataset
from omnifusion_torch.data.loader import DataLoader

__all__ = ["DataLoader", "SyntheticDataset"]
