"""fit.turnaround_ms: _spans.turnaround_ms (the median segment boundary, net of
its image logs), in the stage-2 fit cells' traced job."""

from benchmark.metrics._spans import turnaround_ms as read  # noqa: F401
