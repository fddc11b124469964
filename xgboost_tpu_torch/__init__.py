"""xgboost_tpu_torch: the PyTorch/CUDA port of ``xgboost_tpu``.

Dense ``DMatrix`` construction and quantile binning, the depthwise
``tpu_hist`` grower, ``binary:logistic`` / ``reg:squarederror``, AUC /
logloss / error / rmse evaluation, the forest-walk predictor and XGBoost-
schema JSON model IO. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. The two kernels of the main path are hand-written
CUDA (``csrc/``), built at first use; on CPU tensors their plain PyTorch
versions run.
"""

from .data.dmatrix import DMatrix
from .data.quantile import HistogramCuts
from .learner import Booster
from .predictor import forest_from_numpy
from .training import train

__version__ = "0.1.0"

__all__ = ["DMatrix", "Booster", "train", "HistogramCuts", "forest_from_numpy"]
