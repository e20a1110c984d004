"""step.model_ms: _spans.part_ms of the step's model part (the family's
model forward and its backward to the parameters: MANO, the arm or
NIMBLE; a part of step.geometry_ms), in the stage-2 fit cells' traced job.
None from a program whose stamp table has no "posed" slot."""

from benchmark.metrics._spans import _profiling, part_ms


def read(run):
    prof = _profiling()
    if prof is None or "posed" not in getattr(prof, "STAMP_SLOTS", ()):
        return None
    return part_ms(run, "model")
