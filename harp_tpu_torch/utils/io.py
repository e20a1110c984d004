"""Checkpoint / result IO (harp_tpu/utils/io.py).

- save_result / load_result: the reference's pickled parameter dict of
  numpy arrays, saved_params[_test].pkl, readable by harp_tpu.
- save_checkpoint / load_checkpoint: the full fit state through torch.save
  (params, both Adam state dicts, epoch, plateau state), written to a
  temporary file and renamed, so an interrupted write leaves the previous
  checkpoint whole.
- export_obj: the posed mesh as an OBJ with wedge UVs and an MTL.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch


def _atomic_write(write, path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_result(params: dict, base_output_dir: str, test: bool = False) -> str:
    path = os.path.join(base_output_dir, f"saved_params{'_test' if test else ''}.pkl")
    payload = {k: (v.detach().cpu().numpy() if v is not None else None)
               for k, v in params.items()}
    _atomic_write(lambda f: pickle.dump(payload, f), path)
    return path


def load_result(base_output_dir: str, test: bool = False, device="cpu") -> dict:
    """The saved parameters as float32 leaf tensors with requires_grad."""
    path = os.path.join(base_output_dir, f"saved_params{'_test' if test else ''}.pkl")
    with open(path, "rb") as f:
        params = pickle.load(f)
    return {k: (torch.tensor(np.asarray(v), device=device, requires_grad=True)
                if v is not None else None) for k, v in params.items()}


def save_checkpoint(path: str, params: dict, opt_states: dict, epoch: int,
                    plateau_scale: float = 1.0, extra: dict | None = None) -> None:
    """opt_states: {"coarse": Adam.state_dict(), "app": ...}."""
    payload = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "opt_states": opt_states,
        "epoch": int(epoch),
        "plateau_scale": float(plateau_scale),
        "extra": extra or {},
    }
    _atomic_write(lambda f: torch.save(payload, f), path)


def load_checkpoint(path: str, device="cpu") -> dict:
    """The checkpoint payload; params come back as leaf tensors with
    requires_grad on `device` (the optimizers move their state to the
    parameters' device when they load it)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    payload["params"] = {k: v.to(device).requires_grad_(True)
                         for k, v in payload["params"].items()}
    return payload


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray,
               verts_uvs: np.ndarray | None = None,
               faces_uvs: np.ndarray | None = None,
               texture_png: str | None = None) -> None:
    """An OBJ, with wedge UVs and an MTL naming the texture when given."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    mtl_lines = []
    if texture_png is not None:
        mtl_path = os.path.splitext(path)[0] + ".mtl"
        with open(mtl_path, "w") as m:
            m.write("newmtl material_0\nmap_Kd %s\n" % os.path.basename(texture_png))
        mtl_lines = ["mtllib %s" % os.path.basename(mtl_path), "usemtl material_0"]
    with open(path, "w") as f:
        for line in mtl_lines:
            f.write(line + "\n")
        for v in np.asarray(verts):
            f.write("v %.6f %.6f %.6f\n" % tuple(v))
        if verts_uvs is not None:
            for vt in np.asarray(verts_uvs):
                f.write("vt %.6f %.6f\n" % tuple(vt))
        faces = np.asarray(faces) + 1
        if verts_uvs is not None and faces_uvs is not None:
            for fv, ft in zip(faces, np.asarray(faces_uvs) + 1):
                f.write("f %d/%d %d/%d %d/%d\n" % (fv[0], ft[0], fv[1], ft[1], fv[2], ft[2]))
        else:
            for fv in faces:
                f.write("f %d %d %d\n" % tuple(fv))
