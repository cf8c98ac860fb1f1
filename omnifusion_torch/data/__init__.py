from omnifusion_torch.data.datasets import (
    MatterportDataset,
    PanoDepthDataset,
    SemanticDataset,
    StanfordDataset,
    SyntheticDataset,
    SyntheticSemanticDataset,
    ThreeSixtyDDataset,
    make_dataset,
)
from omnifusion_torch.data.loader import DataLoader

__all__ = [
    "DataLoader",
    "MatterportDataset",
    "PanoDepthDataset",
    "SemanticDataset",
    "StanfordDataset",
    "SyntheticDataset",
    "SyntheticSemanticDataset",
    "ThreeSixtyDDataset",
    "make_dataset",
]
