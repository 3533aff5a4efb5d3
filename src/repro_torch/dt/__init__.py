"""Decision-tree dataset substrate (paper §III, Table II).

Only Fisher's Iris is embedded (canonical UCI values); the remaining seven
Table II datasets are *synthetic generators matched to Table II shapes*
(instances/features/classes) with planted axis-aligned rule structure, so
CART trees land in the same LUT-size regime as the paper's Table V.
"""
from .datasets import DATASETS, DatasetSpec, load, load_split, normalize

__all__ = ["DATASETS", "DatasetSpec", "load", "load_split", "normalize"]
