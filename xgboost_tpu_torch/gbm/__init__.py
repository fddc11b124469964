from .gbtree import GBTree, GBTreeModel

__all__ = ["GBTree", "GBTreeModel"]
