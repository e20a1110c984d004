"""Per-sequence fitting: parameters, the two Adam groups, the train step,
the staged fit and its evaluation; the batch fit over many sequences."""

from harp_tpu_torch.fit.batch import BatchFitData, fit_sequences_batch
