"""Chip-health pieces the single-tree server needs: the golden-vector
canary (built at server construction) and the march helpers it is made
from."""
from .bist import march_probes, row_match
from .canary import CanaryProbe, make_canary

__all__ = ["CanaryProbe", "make_canary", "march_probes", "row_match"]
