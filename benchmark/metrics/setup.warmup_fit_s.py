"""setup.warmup_fit_s: _spans.warmup_fit_s, in the stage-2 fit cells' traced run."""

from benchmark.metrics._spans import warmup_fit_s as read  # noqa: F401
