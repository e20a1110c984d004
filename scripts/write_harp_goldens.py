"""Write harp_tpu's side of the port's parity tests anew: tests/golden/harp_tpu_*.npz.

Each golden has a `slow` regenerator test beside the parity tests that read
it (`test_harp_tpu_golden_of_*_is_current`): it reruns the golden's generator
on the file's own inputs and fixtures and checks the result against the
stored file. This script runs those tests with the check replaced by a write,
so a golden is written from exactly what its check would compare. Write them
when harp_tpu's numbers or a parity scene change on purpose; the generators
and their inputs are listed in tests/golden/README.

Run (all, or some by name):

    JAX_PLATFORMS=cpu python scripts/write_harp_goldens.py
    JAX_PLATFORMS=cpu python scripts/write_harp_goldens.py -k scan_fit

Then check them: JAX_PLATFORMS=cpu python -m pytest tests -m slow -k harp_tpu_golden
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import _harp_goldens as goldens  # noqa: E402


def _write(name: str, fresh: dict, tolerance) -> None:
    path = os.path.join(goldens.GOLDEN, f"{name}.npz")
    np.savez_compressed(path, **fresh)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    goldens.assert_current = _write
    os.chdir(ROOT)
    sys.exit(pytest.main(["tests", "-m", "slow", "-k", "harp_tpu_golden", "-p", "no:xdist",
                          "-p", "no:cacheprovider", "-q", *sys.argv[1:]]))
