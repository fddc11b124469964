from .dmatrix import DMatrix
from .quantile import BinnedMatrix, HistogramCuts, bin_matrix, compute_cuts

__all__ = ["DMatrix", "BinnedMatrix", "HistogramCuts", "bin_matrix",
           "compute_cuts"]
