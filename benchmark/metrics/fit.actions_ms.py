"""fit.actions_ms: _common.actions_ms, in the stage-2 fit cells."""

from benchmark.metrics._common import actions_ms as read  # noqa: F401
