from omnifusion_torch.data.datasets import (
    MatterportDataset,
    PanoDepthDataset,
    StanfordDataset,
    SyntheticDataset,
    ThreeSixtyDDataset,
    make_dataset,
)
from omnifusion_torch.data.loader import DataLoader

__all__ = [
    "DataLoader",
    "MatterportDataset",
    "PanoDepthDataset",
    "StanfordDataset",
    "SyntheticDataset",
    "ThreeSixtyDDataset",
    "make_dataset",
]
