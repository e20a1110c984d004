"""Per-sequence fitting: parameters, the two Adam groups, the train step."""
