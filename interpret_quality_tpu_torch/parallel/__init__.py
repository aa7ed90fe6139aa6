"""The coalition split over devices."""
from .mesh import SplitForward, coalition_split, make_mesh

__all__ = ["SplitForward", "coalition_split", "make_mesh"]
