from .dmatrix import DMatrix, QuantileDMatrix, load_row_split
from .quantile import BinnedMatrix, HistogramCuts, bin_matrix, compute_cuts

__all__ = ["DMatrix", "QuantileDMatrix", "load_row_split", "BinnedMatrix",
           "HistogramCuts", "bin_matrix", "compute_cuts"]
