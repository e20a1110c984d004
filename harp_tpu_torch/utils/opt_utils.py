"""Debug helpers of the fit (harp_tpu/utils/opt_utils.py): min-max scaling
and the rainbow vertex colours of a template."""

from __future__ import annotations

import numpy as np


def min_max_scale(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """x scaled to [0, 1] along `axis`, float32."""
    x = np.asarray(x, np.float32)
    lo = x.min(axis=axis, keepdims=True)
    hi = x.max(axis=axis, keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-9)


def get_vert_colors(v_template: np.ndarray) -> np.ndarray:
    """Rainbow debug colours: the template's xyz min-max scaled into RGB."""
    return min_max_scale(np.asarray(v_template), axis=0)
