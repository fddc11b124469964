"""The plain reference of the benchmark: a histogram GBDT in plain PyTorch.

Cuts and bins (``quantile``), the objectives' gradients (``objective``,
with a frozen copy of the threefry draw in ``threefry``), the greedy
depthwise grower, the walk and the judge of a given tree (``tree``), and
the evaluation metrics (``metric``). It imports nothing of the system
under test and takes nothing it made: it works everything out again from
the raw rows and labels the benchmark hands to both.
"""
