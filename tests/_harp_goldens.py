"""harp_tpu's side of the port's parity tests, computed once and stored.

harp_tpu is the frozen reference and these fixtures' seeds are fixed, so every
run of the suite would compute the same reference numbers again. The parity
fixtures that take longest read harp_tpu's numbers from
tests/golden/<name>.npz instead; the port's side is still computed live. Each
test file that reads a golden holds its generator (the harp_tpu call, on the
inputs the file builds) and one `slow` test that reruns it and holds the
result to the stored file within SHARE of the parity test's tolerances, which
the file keeps as module constants that both read. tests/golden/README names
the calls.

Check every golden against a fresh harp_tpu run, or write them anew:

    JAX_PLATFORMS=cpu python -m pytest tests -m slow -k harp_tpu_golden
    JAX_PLATFORMS=cpu python scripts/write_harp_goldens.py"""

import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def pack(**parts) -> dict:
    """A golden's arrays. A part that is a list of dicts (a fit's history)
    becomes `<part>` (epochs x keys in float64, which holds harp_tpu's
    Python floats exactly), `<part>_keys` (their sorted union) and
    `<part>_has` (which epoch logs which key); a dict becomes an array per
    entry, `<part>.<key>`; anything else one array, `<part>`."""
    out = {}
    for name, value in parts.items():
        if isinstance(value, list) and value and isinstance(value[0], dict):
            keys = sorted(set().union(*value))
            out[f"{name}_keys"] = np.array(keys)
            out[f"{name}_has"] = np.array([[k in h for k in keys] for h in value])
            out[name] = np.array([[float(h.get(k, 0.0)) for k in keys] for h in value])
        elif isinstance(value, dict):
            out.update({f"{name}.{k}": np.asarray(v) for k, v in value.items()})
        else:
            out[name] = np.asarray(value)
    return out


def part(g: dict, name: str):
    """A part of a golden as pack took it: a history (epochs as ints), a
    dict of arrays, or an array."""
    if f"{name}_keys" in g:
        keys = [str(k) for k in g[f"{name}_keys"]]
        return [{k: int(v) if k == "epoch" else float(v)
                 for k, v, has in zip(keys, row, row_has) if has}
                for row, row_has in zip(g[name], g[f"{name}_has"])]
    if name in g:
        return g[name]
    return {k[len(name) + 1:]: v for k, v in g.items() if k.startswith(f"{name}.")}


def load(name: str) -> dict:
    with np.load(os.path.join(GOLDEN, f"{name}.npz")) as f:
        return dict(f)


# A regenerator holds a fresh harp_tpu run to this share of its parity test's
# tolerances: JAX on the CPU repeats its numbers to the last bits or nearly,
# and the port, held to a stored golden, then stands within 1 + SHARE of each
# tolerance of a fresh harp_tpu run.
SHARE = 0.1


def assert_current(name: str, fresh: dict, tolerance) -> None:
    """A generator's fresh arrays against the stored golden `name`: the same
    keys; an array for which tolerance(key, stored array) is not None within
    SHARE of that tolerance (a scalar or an array of the array's shape) entry
    by entry, and every other array equal. scripts/write_harp_goldens.py puts
    a writer in its place."""
    want_all = load(name)
    assert fresh.keys() == want_all.keys()
    for k, want in want_all.items():
        t = tolerance(k, want)
        if t is None:
            np.testing.assert_array_equal(fresh[k], want, err_msg=k)
        else:
            d = np.abs(fresh[k] - want)
            assert (d <= SHARE * t).all(), (k, float(d.max()))
