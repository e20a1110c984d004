"""Model families as files (benchmark/families/<model>.py, found by the
configuration's "model" value and loaded by path):

- the hand's and the arm's inputs and reference fit are the same bits as
  before the families moved into files: SHA-256 digests of the tiny cells'
  inputs (frames, masks, initial and rendered parameters, model arrays,
  VGG filters) and of the reference's first two epochs (history,
  parameters after them, first gradients, start), recorded with torch on
  the CPU at one thread before the move. A digest holds for one build of
  torch on one kind of CPU: on another, record it anew from the commit
  before the move (benchmark/inputs.make_inputs, benchmark/check.
  reference_fit; the helpers below);
- a family added as new files alone, in a copy of the benchmark, runs a
  tiny cell to `correct` true, and an unknown family's message names the
  file to write;
- a family's statics (`extras`) reach the program's fit_sequence and the
  reference's TrainStep: HTML's texture basis, the program's from
  harp_tpu_torch and the reference's from its plain copy.
"""

from __future__ import annotations

import dataclasses
import filecmp
import hashlib
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import REPO, tiny_spec

CPU = torch.device("cpu")


def feed(h, x) -> None:
    """Hash x's values, dtypes, shapes and field names into h."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        h.update(f"{x.dtype.str}{x.shape}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif dataclasses.is_dataclass(x):
        h.update(type(x).__name__.encode())
        for f in dataclasses.fields(x):
            if not f.name.startswith("_"):  # caches made at first use
                h.update(f.name.encode())
                feed(h, getattr(x, f.name))
    elif isinstance(x, dict):
        for k in sorted(x):
            h.update(repr(k).encode())
            feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        h.update(b"[%d" % len(x))
        for v in x:
            feed(h, v)
    elif isinstance(x, float):
        h.update(x.hex().encode())
    else:
        h.update(repr(x).encode())


def sha(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        feed(h, x)
    return h.hexdigest()


PINNED = {  # (configuration, seed): (inputs, reference fit)
    ("hand_mano_448", 12345): (
        "bb3c639ef26f1c991afc7dd21e3de74f9bbb9a2ab47dd22f9c5fc8c7a7f3f716",
        "cc43abf61e82c435cce9dd056deb259964d534a06449a684dec8645805078121"),
    ("hand_mano_448", 2**31 + 7): (
        "7d9b1fc591708b76e701fd50d4eaaeea8a3ddbf6ec2242c43047a136ab67e1ff",
        "7c948ebf893b60f28a2bd14f27c3c84ae635647cd0be855957c55a53907e679c"),
    ("arm_smplx_448", 12345): (
        "db471c371bdb50c30ea1e3c386106686f26cfcde50a86a9c3063fc4e546337d7",
        "a1e3b717b77ff513e36e700f53098ec4ea25e5b345dcb2ac8d4ac3bbcb1d5f97"),
    ("arm_smplx_448", 2**31 + 7): (
        "b2b5a098977e1fe935565c674d069269f1db9a754209f3b96e46d8d0da1af43a",
        "eda071899fd672d126a144f4337f8265b1ed3ade514ee5cb0fdaba5a0a93c763"),
}


@pytest.mark.parametrize("base,seed", sorted(PINNED))
def test_the_inputs_and_the_reference_fit_are_the_pinned_bits(base, seed):
    from benchmark.check import reference_fit
    from benchmark.inputs import make_inputs

    inp = make_inputs(tiny_spec(base), seed, CPU, {"stages": [0, 2, 0]})
    ref = reference_fit(inp, 2)
    got = (sha(inp.images, inp.masks, inp.masks_eroded, inp.input_params, inp.gt_params,
               inp.ref_assets, inp.vgg_weights),
           sha(ref["history"], ref["params"], ref["first_grads"], ref["params0"]))
    assert got == PINNED[(base, seed)]


TINY_FAMILY = '''"""The hand at another ring count: a family written as a new file."""

from benchmark.inputs import program_avatar
from benchmark.reference import assets as ref_assets


def reference_assets(spec, seed, uv_size):
    return ref_assets.build_synthetic_assets(n_ring=spec["n_ring"], seed=seed, uv_size=uv_size)


def program_assets(inputs):
    from harp_tpu_torch.models.mano import ManoModel

    return program_avatar(inputs.ref_assets, ManoModel)


def reference_extras(inputs):
    return None


def program_extras(inputs):
    return None
'''

TINY_HTML = '''"""The hand with HTML's texture basis (101 coefficients) as its
appearance: the program's basis from harp_tpu_torch, the reference's from
its plain copy, both drawn from seed 3 at the texture's size."""

from benchmark.inputs import program_avatar
from benchmark.reference import assets as ref_assets
from benchmark.reference.models import html


def reference_assets(spec, seed, uv_size):
    return ref_assets.build_synthetic_assets(seed=seed, uv_size=uv_size, density=spec["density"])


def program_assets(inputs):
    from harp_tpu_torch.models.mano import ManoModel

    return program_avatar(inputs.ref_assets, ManoModel)


def reference_extras(inputs):
    size = inputs.ref_config.texture_size
    return {"texture_basis": html.synthetic_texture_basis(size, 101, seed=3)}


def program_extras(inputs):
    from harp_tpu_torch.models.html import synthetic_texture_basis

    size = inputs.ref_config.texture_size
    return {"texture_basis": synthetic_texture_basis(size, 101, seed=3)}
'''


def add_cell(root, cell: str, spec: dict, family_src: str | None = None) -> None:
    """Add the cell `cell` to the copy at root as new files and entries:
    its configuration (spec), its traffic (the tiny fit's) and limits (the
    hand's), and with family_src the family spec["model"]."""
    bench_dir = root / "benchmark"
    if family_src is not None:
        (bench_dir / "families" / (spec["model"] + ".py")).write_text(family_src)
    (bench_dir / "configs" / (spec["name"] + ".json")).write_text(json.dumps(spec))
    traffic = json.loads((bench_dir / "traffic" / "tiny_fit.json").read_text())
    (bench_dir / "traffic" / (spec["name"] + "_fit.json")).write_text(json.dumps(traffic))
    limits = (bench_dir / "limits" / "hand.fit_stage2.json").read_text()
    (bench_dir / "limits" / (cell + ".json")).write_text(limits)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": spec["name"], "source": "test", "reduced": [],
                             "file": f"benchmark/configs/{spec['name']}.json", "why": "test"})
    bench["workloads"].append({"name": cell, "config": spec["name"],
                               "traffic": spec["name"] + "_fit", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "fit_frames_per_s")["workloads"].append(
        cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def shared_files_differ(root) -> list:
    """Files of the copy's benchmark/ that the repository has too and that
    differ from it."""
    repo = os.path.join(REPO, "benchmark")
    out = []
    for d, dirs, files in os.walk(root / "benchmark"):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root / "benchmark")
            theirs = os.path.join(repo, rel)
            if os.path.exists(theirs) and not filecmp.cmp(os.path.join(d, f), theirs,
                                                          shallow=False):
                out.append(rel)
    return out


def run(mod, name, tmp_path):
    return mod.run_cell(name, 2**31 + 11, 1e-3, False, CPU, time.perf_counter(),
                        str(tmp_path / "out"))


def test_a_family_added_as_new_files_runs_a_cell_to_correct(bench_copy, tmp_path):
    root, mod = bench_copy
    spec = dict(tiny_spec(), name="tiny_family_cfg", model="tiny_family", n_ring=6)
    add_cell(root, "tiny_family.fit", spec, TINY_FAMILY)
    missing = dict(spec, name="no_family_cfg", model="no_such_family")
    add_cell(root, "no_family.fit", missing)
    assert shared_files_differ(root) == []
    res = run(mod, "tiny_family.fit", tmp_path)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 1
    want = str(root / "benchmark" / "families" / "no_such_family.py")
    with pytest.raises(ValueError, match="write " + re.escape(want)):
        run(mod, "no_family.fit", tmp_path)
    # BENCHMARK.json differs from the repository's by the added entries alone.
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        theirs = json.load(f)
    ours = json.loads((root / "BENCHMARK.json").read_text())
    added = {"tiny.fit", "tiny_family.fit", "no_family.fit", "tiny_hand", "tiny_family_cfg",
             "no_family_cfg", "tiny.jobs"}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        kept = [m for m in ours[key] if m["name"] not in added]
        for m in kept:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"] if w not in added]
        assert kept == theirs[key]


def test_a_familys_extras_reach_both_sides(bench_copy, tmp_path, monkeypatch):
    from harp_tpu_torch.fit import driver
    from harp_tpu_torch.models.html import TextureBasis

    from benchmark.reference import follow
    from benchmark.reference.models.html import TextureBasis as RefTextureBasis

    root, mod = bench_copy
    spec = dict(tiny_spec(), name="tiny_html_cfg", model="tiny_html")
    spec["harp_config"] = dict(spec["harp_config"], model_type="html")
    add_cell(root, "tiny_html.fit", spec, TINY_HTML)
    seen = {"program": [], "reference": []}
    fit_sequence, train_step = driver.fit_sequence, follow.TrainStep

    def program_fit(*args, **kw):
        seen["program"].append(kw.get("extras"))
        return fit_sequence(*args, **kw)

    def reference_step(*args, **kw):
        seen["reference"].append(kw.get("extras"))
        return train_step(*args, **kw)

    monkeypatch.setattr(driver, "fit_sequence", program_fit)
    monkeypatch.setattr(follow, "TrainStep", reference_step)
    res = run(mod, "tiny_html.fit", tmp_path)
    assert len(seen["program"]) == 2 and len(seen["reference"]) == 1  # warm-up and job; check
    for extras in seen["program"]:
        assert isinstance(extras["texture_basis"], TextureBasis)
    assert isinstance(seen["reference"][0]["texture_basis"], RefTextureBasis)
    assert all(e["texture_basis"].num_coeffs == 101 for side in seen.values() for e in side)
    assert "html_texture" in res["compared"]["change_gap"]["leaves"]
    assert res["correct"], res["compared"]
