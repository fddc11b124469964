"""xgboost_tpu_torch: the PyTorch/CUDA port of ``xgboost_tpu``.

``DMatrix`` construction from numpy, torch, scipy sparse (kept sparse on
the host), pandas, arrow, lists and libsvm / csv / binary files, with
query groups; ``QuantileDMatrix`` (binned at construction, on a reference
matrix's cuts where given), the ``DataIter`` protocol's streaming matrix
and ``ExternalMemoryQuantileDMatrix`` (bins paged on disk, every level of
training streaming the pages); quantile binning,
the depthwise ``tpu_hist`` grower, the JAX package's objectives and
metrics (the regression family, multiclass softmax with K trees per round,
survival with censoring intervals, LambdaMART ranking and the ranking
metrics), the forest-walk predictor and XGBoost-schema JSON model IO; the
training surface around them: ``train`` with callbacks, early stopping,
custom objectives and metrics and continued training, ``cv``, and the
``Booster``'s predict options (SHAP contributions and interactions
included), slicing, copies, pickling, attributes, configuration and model
inspection (dumps, importance); the linear booster (``booster="gblinear"``),
the scikit-learn estimators (imported at first use), ``set_config`` /
``config_context`` and the plots. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. Distributed training over
``torch.distributed`` (``parallel``: ``init_distributed``, ``make_mesh``,
``mesh_context``; one rank per device, each on its own rows, the level
histograms all-reduced), the rabit shim (``collective``, alias
``rabit``), and elastic training (``elastic_train``, ``elastic_exit``:
heartbeat membership in a shared directory, ``parallel.membership``; a
lost worker shrinks the world, which replays from the newest verified
checkpoint). ``python -m xgboost_tpu_torch`` is the command line
(``cli.py``: the config-file ``train`` / ``dump`` / ``pred`` tasks,
``trace-report``, ``obs-report`` and ``checkpoint-inspect``, ``serve``, ``deliver``). Serving (``serving``):
``ModelServer``, a micro-batched, multi-tenant model server with hot
swap, SLO admission (``RequestShed``), fault isolation (``RequestError``)
and delivery, over the serving fast path of ``Booster.inplace_predict``.
Telemetry
(``observability``): span tracing to Chrome trace-event files
(``XGBTPU_TRACE`` or ``set_config(trace_path=...)``),
the metrics registry, collective accounting and the per-round flight
recorder (``observability.flight.configure(run_dir)``);
``profiler_context`` wraps ``torch.profiler``. The failure-handling layer
(``resilience``): retry policy, chaos sites, the watchdog and crash-safe
checkpoints behind ``train(resume_from=...)``. The five kernels of the path (the
construct and hoisted level histograms, the one-hot build, the strict-order
scan of split evaluation and the forest walk) are hand-written CUDA
(``csrc/``), built at first use; on CPU
tensors their plain PyTorch versions run. The native host runtime
(``native``: the libsvm / csv parser, the page cache and the C API
library ``libxgbtpu_torch``) is C++ built with ``g++`` at first use.
``build_info()`` reports the backend and what is built.
"""

from . import callback, collective, observability, parallel, resilience
from . import collective as rabit  # noqa: F401  (legacy alias)
from .config import config_context, get_config, set_config
from .data.dmatrix import DMatrix, QuantileDMatrix, load_row_split
from .data.external import ExternalMemoryQuantileDMatrix
from .data.iterator import DataIter
from .data.quantile import HistogramCuts
from .gbm import Dart, GBLinear, GBTree
from .learner import Booster
from .plotting import plot_importance, plot_tree, to_graphviz
from .predictor import forest_from_numpy
from .serving import ModelServer, RequestError, RequestShed
from .training import cv, elastic_exit, elastic_train, train
from .utils.timer import profiler_context

__version__ = "0.1.0"

__all__ = ["DMatrix", "QuantileDMatrix", "ExternalMemoryQuantileDMatrix",
           "DataIter", "load_row_split", "Booster", "train", "cv",
           "elastic_train", "elastic_exit",
           "callback", "collective", "rabit", "parallel", "observability",
           "resilience", "ModelServer", "RequestError", "RequestShed",
           "profiler_context", "HistogramCuts",
           "forest_from_numpy", "config_context", "set_config", "get_config",
           "plot_importance", "plot_tree", "to_graphviz", "XGBModel",
           "XGBRegressor", "XGBClassifier", "XGBRanker", "XGBRFRegressor",
           "XGBRFClassifier", "GBTree", "Dart", "GBLinear", "build_info",
           "__version__"]


def build_info() -> dict:
    """Build and runtime facts (reference ``xgboost.build_info``), under
    the JAX package's keys: ``backend`` ``"cuda"`` where a card is present,
    else ``"cpu"``; ``pallas_kernels``, whether the hand-written kernels
    (``csrc/``, the counterparts of the JAX package's Pallas kernels) are
    the route, as they are for every tensor on a card; ``native_pagecache``,
    whether the native page cache (``native/pagecache.cpp``) builds and
    loads here (a report: the page reader itself raises where it does
    not); ``devices``, the backend's device count."""
    import torch

    from . import native

    cuda = torch.cuda.is_available()
    try:
        native.pagecache()
        pagecache = True
    except (OSError, RuntimeError):
        pagecache = False
    return {"backend": "cuda" if cuda else "cpu", "pallas_kernels": cuda,
            "native_pagecache": pagecache,
            "devices": torch.cuda.device_count() if cuda else 1}

_ESTIMATORS = ("XGBModel", "XGBRegressor", "XGBClassifier", "XGBRanker",
               "XGBRFRegressor", "XGBRFClassifier")


def __getattr__(name):
    # the estimators load at first use, as in the JAX package
    if name in _ESTIMATORS:
        import importlib

        return getattr(importlib.import_module(".sklearn", __name__), name)
    raise AttributeError(
        f"module 'xgboost_tpu_torch' has no attribute '{name}'")
