"""kernels.roofline_pct: _common.roofline_pct, in the stage-2 fit cells."""

from benchmark.metrics._common import roofline_pct as read  # noqa: F401
