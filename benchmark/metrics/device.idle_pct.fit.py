"""device.idle_pct.fit: _common.idle_pct, in the stage-2 fit cells' traced job."""

from benchmark.metrics._common import idle_pct as read  # noqa: F401
