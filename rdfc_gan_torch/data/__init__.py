from .loader import DataLoader, build_dataloader
from .synthetic import SyntheticDataset
from . import (ddrnet_human, folder_dataset, nyuv2, nyuv2_r2r,  # noqa: F401
               nyuv2_s2d, sunrgbd)  # (register the file datasets)

__all__ = ["DataLoader", "SyntheticDataset", "build_dataloader"]
