"""step.vgg_ms: _spans.part_ms of the step's vgg part, in the stage-2 fit cells'
traced job."""

from benchmark.metrics._spans import part_ms


def read(run):
    return part_ms(run, "vgg")
