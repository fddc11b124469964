"""The plain reference of the benchmark: a histogram GBDT in plain PyTorch.

Cuts and bins (``quantile``), the greedy depthwise grower, the walk and
the judge of a given tree (``tree``), rows in queries (``queries``) and a
frozen copy of the threefry draw (``threefry``). Each objective's
gradients are the file ``objectives/<name>.py`` and each evaluation
metric the file ``metrics/<name>.py``, found by name (``lookup.py``). It
imports nothing of the system under test and takes nothing it made: it
works everything out again from the raw rows and labels the benchmark
hands to both.
"""
