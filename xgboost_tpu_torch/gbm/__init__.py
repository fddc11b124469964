from .gblinear import GBLinear
from .gbtree import Dart, GBTree, GBTreeModel

__all__ = ["Dart", "GBLinear", "GBTree", "GBTreeModel"]
