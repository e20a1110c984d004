"""The benchmark of harp_tpu_torch on NVIDIA GPUs.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json, its configuration from
benchmark/configs/<config>.json, its model family from
benchmark/families/<model>.py (benchmark/inputs.py says what it
defines), its traffic from benchmark/traffic/<traffic>.json and the
limits of its compared numbers from benchmark/limits/<cell>.json; each
metric is a reader in benchmark/metrics/<name>.py. Set-up (timed as
setup_s, from this module's import): the inputs from --seed, the
program's objects, one warm-up job. Then jobs run back to back for
--seconds (every job counted whole), the peak device memory is read, the
program's state is freed and the output check runs against the plain
reference. The last line of standard output is one JSON object; the
numbers compared, each with its limit, are also the last lines of
standard error. Exits non-zero without a CUDA device, without the
program, or if jax, jaxlib, flax or harp_tpu were loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "harp_tpu")


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (harp_tpu_torch is not harp_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(name: str) -> tuple:
    """(cell, configuration, traffic with the cell's limits of `correct`,
    end-to-end and per-layer metric entries) by name."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    spec = load_json(ROOT, config["file"])
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layers = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    traffic["limits"] = load_json(HERE, "limits", name + ".json")
    return cell, spec, traffic, e2e, layers


def reader(metric: str):
    """The per-layer metric's reader: benchmark/metrics/<name>.py's read."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             out_root: str) -> dict:
    """Set-up, window, check; returns the result's fields (device-free
    parts, so that tests can drive it on the CPU)."""
    import torch

    from benchmark import check
    from benchmark.inputs import make_inputs
    from benchmark.jobs import KINDS
    from benchmark.trace import summarize, traced

    cell, spec, traffic, e2e, layers = find_cell(name)
    inputs = make_inputs(spec, seed, device, traffic, families=os.path.join(HERE, "families"))
    if device.type == "cuda":  # the peak is the program's, not the input renderer's
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    kind = KINDS[traffic["kind"]](inputs, traffic)
    kind.warmup(os.path.join(out_root, "warmup"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    jobs, prof = [], {}
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        out_dir = os.path.join(out_root, f"job{len(jobs)}")
        if trace and len(jobs) == 1 and device.type == "cuda":
            with traced(device, prof):
                jobs.append(kind.job(out_dir))
        else:
            jobs.append(kind.job(out_dir))
        shutil.rmtree(out_dir, ignore_errors=True)
    window_s = time.perf_counter() - t_start - prof.get("overhead_s", 0.0)
    if "_prof" in prof:
        summarize(prof)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind.release()
    compared = check.run(kind, traffic)
    failed = sum(j["failed"] is not None for j in jobs)
    run = {"cell": cell, "spec": spec, "traffic": traffic, "jobs": jobs, "window_s": window_s,
           "setup_s": setup_s, "trace": prof, "config": kind.config}
    metrics = {}
    if trace:
        for m in layers:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": reader(m["name"])(run), "unit": m["unit"]}
    ok = all(c["value"] <= c["limit"] for c in compared.values()) and failed == 0
    return {"correct": ok, "attempted": len(jobs), "failed": failed, "metrics": metrics,
            "peak": peak, "compared": compared, "trace": prof,
            "jobs": jobs, "failures": [j["failed"] for j in jobs if j["failed"]][:3]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    cell = find_cell(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"needs {cell['chips']} CUDA device(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}")
    if importlib.util.find_spec("harp_tpu_torch") is None:
        fail("the program (harp_tpu_torch) is not in this checkout")
    os.environ.setdefault("USE_FLAX", "0")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the configuration's float32
    with tempfile.TemporaryDirectory(prefix="benchmark_") as out_root:
        res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, _T0,
                       out_root)
    loaded = forbidden_modules()
    if loaded:
        fail(f"modules {loaded} were loaded in this process", 3)
    for i, j in enumerate(res["jobs"]):
        print(json.dumps({"job": i, "wall_s": j["wall_s"], "failed": j["failed"]}))
    for j in res["failures"]:
        print(f"failed job: {j}", file=sys.stderr)
    checks_line = {k: {"value": c["value"], "limit": c["limit"]} for k, c in
                   res["compared"].items()}
    for k, c in res["compared"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} ({c.get('at')})", file=sys.stderr)
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                  "memory_peak_bytes": int(res["peak"])}
    if args.trace:
        device_rec["busy_s"] = res["trace"].get("busy_s", 0.0)
        device_rec["window_s"] = res["trace"].get("window_s", 0.0)
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"], "device": device_rec}
    if args.trace and "breakdown" in res["trace"]:
        out["breakdown"] = res["trace"]["breakdown"]
    out["checks"] = checks_line
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
