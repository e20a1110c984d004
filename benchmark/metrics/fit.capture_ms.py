"""fit.capture_ms: _common.capture_ms, in the stage-2 fit cells."""

from benchmark.metrics._common import capture_ms as read  # noqa: F401
