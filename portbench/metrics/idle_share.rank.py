"""Device idle share of a ranking round at the program's own pace, %."""

from portbench.readers import idle_share as read  # noqa: F401
