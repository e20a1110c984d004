"""step.device_ms: _spans.part_ms of the whole step: the stamp at its end
minus the stamp at its start, in the stage-2 fit cells'
traced job."""

from benchmark.metrics._spans import part_ms


def read(run):
    return part_ms(run, "step")
