"""The benchmark of ``xgboost_tpu_torch`` (run it as ``python3 portbench/run.py``)."""
