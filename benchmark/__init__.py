"""The benchmark of harp_tpu_torch: `python3 -m benchmark.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` (run.py). Cells are entries
of BENCHMARK.json; configurations, model families, traffic, limits of
`correct` and metric readers are files found by name under configs/,
families/, traffic/, limits/ and metrics/; reference/ is the plain
reference the output check holds the program to; roofline/ the
yardstick's counts and peaks."""
