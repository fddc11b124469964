"""Host utilities (the port of the JAX package's ``utils``): the
verbosity-gated ``console_logger``, the ``Monitor`` timers and the
scripted fault triggers (``fault``)."""

from . import fault  # noqa: F401
from .log import Logger, console_logger  # noqa: F401
from .timer import Monitor, profiler_context  # noqa: F401
