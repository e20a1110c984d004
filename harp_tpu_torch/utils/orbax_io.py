"""Async checkpointing (harp_tpu/utils/orbax_io.py's interface).

harp_tpu writes its async checkpoints through Orbax, an OCDBT store under
{out}/orbax/{step}/. This package has neither Orbax nor tensorstore, so it
cannot read or write OCDBT; it keeps the interface and the place and
writes its own format: {out}/orbax/{step}/checkpoint.pt, the payload
{params, opt_states, epoch, plateau_scale, extra} of utils/io.save_checkpoint.

- save() snapshots the parameters and the optimizer state to the host
  before it returns (the train step updates both in place), then writes on
  one background thread: the epoch loop does not wait for storage.
- Each step is written into a temporary directory and renamed into place,
  so a write cut short never shows as a step.
- Retention keeps the newest max_to_keep steps.

is_ocdbt_tree recognises harp_tpu's own trees; fit/resume.py refuses them
and says how to carry one across.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from harp_tpu_torch.utils.io import load_checkpoint, save_checkpoint

PAYLOAD = "checkpoint.pt"
# Files of an Orbax / OCDBT step directory (harp_tpu's format).
OCDBT_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def snapshot(tree):
    """A host copy of every tensor in a nest of dicts, lists and tuples
    (a CPU tensor is copied too: it may be updated in place later)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


def is_ocdbt_tree(directory: str) -> bool:
    """Whether `directory` (an orbax/ tree) holds harp_tpu's Orbax steps."""
    for _, _, files in os.walk(directory):
        if any(m in files for m in OCDBT_MARKERS):
            return True
    return False


class OrbaxCheckpointer:
    """Async checkpoints in step-numbered directories under {directory}/orbax.

        ckpt = OrbaxCheckpointer(out_dir, max_to_keep=3)
        ckpt.save(epoch, params, opt_states, plateau_scale)   # non-blocking
        ckpt.wait()       # every pending write done (raises a failed one)
        payload = ckpt.restore()          # latest, or restore(step=...)
        ckpt.close()

    opt_states: {"coarse": Adam.state_dict(), "app": ...}. max_to_keep None
    keeps every step."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self.directory = os.path.abspath(os.path.join(directory, "orbax"))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def save(self, step: int, params: dict, opt_states, plateau_scale: float = 1.0,
             extra: dict | None = None) -> None:
        snap = (snapshot(params), snapshot(opt_states), snapshot(extra or {}))
        self._pending.append(self._writer.submit(self._write, int(step), *snap,
                                                 float(plateau_scale)))

    def _write(self, step: int, params, opt_states, extra, plateau_scale: float) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            save_checkpoint(os.path.join(tmp, PAYLOAD), params, opt_states, step,
                            plateau_scale, extra=extra)
            final = os.path.join(self.directory, str(step))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def all_steps(self) -> list:
        """The finished steps, oldest first (a temporary directory is none)."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, PAYLOAD)))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device="cpu") -> dict:
        """The payload of `step` (default the latest), params as leaf
        tensors with requires_grad on `device`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_checkpoint(os.path.join(self.directory, str(step), PAYLOAD), device=device)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
