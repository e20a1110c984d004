"""fit_frames_per_s: _common.frames_per_s, in the stage-2 fit cells."""

from benchmark.metrics._common import frames_per_s as read  # noqa: F401
