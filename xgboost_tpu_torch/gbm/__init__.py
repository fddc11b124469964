from .gbtree import Dart, GBTree, GBTreeModel

__all__ = ["Dart", "GBTree", "GBTreeModel"]
