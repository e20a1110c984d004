"""Per-sequence fitting: parameters, the two Adam groups, the train step,
the staged fit and its evaluation."""
