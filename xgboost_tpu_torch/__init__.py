"""xgboost_tpu_torch: the PyTorch/CUDA port of ``xgboost_tpu``.

Dense ``DMatrix`` construction (with query groups) and quantile binning,
the depthwise ``tpu_hist`` grower, the JAX package's objectives and
metrics (the regression family, multiclass softmax with K trees per round,
survival with censoring intervals, LambdaMART ranking and the ranking
metrics), the forest-walk predictor and XGBoost-schema JSON model IO; the
training surface around them: ``train`` with callbacks, early stopping,
custom objectives and metrics and continued training, ``cv``, and the
``Booster``'s predict options, slicing, copies, pickling, attributes,
configuration and model inspection (dumps, importance). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. The four kernels of the path (the construct and
hoisted level histograms, the one-hot build and the forest walk) are
hand-written CUDA (``csrc/``), built at first use; on CPU tensors their
plain PyTorch versions run.
"""

from . import callback
from .data.dmatrix import DMatrix
from .data.quantile import HistogramCuts
from .learner import Booster
from .predictor import forest_from_numpy
from .training import cv, train

__version__ = "0.1.0"

__all__ = ["DMatrix", "Booster", "train", "cv", "callback", "HistogramCuts",
           "forest_from_numpy"]
