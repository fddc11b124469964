"""Level histograms' share of their roofline in the ranking cells (device trace), %."""

from portbench.readers import level_hist_roofline as read  # noqa: F401
