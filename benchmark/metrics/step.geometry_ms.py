"""step.geometry_ms: _spans.part_ms of the step's geometry part, in the stage-2 fit cells'
traced job."""

from benchmark.metrics._spans import part_ms


def read(run):
    return part_ms(run, "geometry")
