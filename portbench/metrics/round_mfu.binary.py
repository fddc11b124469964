"""A binary round's least time at the card's peaks over its time at the program's own pace, %."""

from portbench.readers import round_mfu as read  # noqa: F401
