from .loader import DataLoader
from .synthetic import SyntheticDataset
from . import nyuv2, sunrgbd  # noqa: F401  (register the file datasets)

__all__ = ["DataLoader", "SyntheticDataset"]
