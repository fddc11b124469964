"""Verbosity-gated console logging (the port of the JAX package's
``utils/log.py``; reference ``ConsoleLogger``,
``include/xgboost/logging.h:39``): 0 silent, 1 warning, 2 info, 3 debug,
read from ``config``'s ``verbosity``."""

from __future__ import annotations

import sys
import time
from typing import Any

from ..config import get_config


class Logger:
    def _emit(self, level: int, tag: str, *args: Any) -> None:
        if get_config()["verbosity"] >= level:
            msg = " ".join(str(a) for a in args)
            print(f"[{time.strftime('%H:%M:%S')}] {tag}: {msg}",
                  file=sys.stderr, flush=True)

    def warning(self, *args: Any) -> None:
        self._emit(1, "WARNING", *args)

    def info(self, *args: Any) -> None:
        self._emit(2, "INFO", *args)

    def debug(self, *args: Any) -> None:
        self._emit(3, "DEBUG", *args)


console_logger = Logger()
