"""Headline benchmark: Fisher-metric application for a 2-D correlated field.

Replicates the reference's JOSS benchmark kernel (``misc/re/paper/
minimal_benchmark.py``): M_p = (likelihood Fisher metric + 1) applied to a
random tangent for a CorrelatedFieldMaker + Poisson model — the operation
dominating MGVI/geoVI wall time.  Sizes are FFT-friendly (2^a·5^b) stand-ins
for the reference's 1309² / 10000² grid points; baselines are the
reference's measured numbers on an NVIDIA A100 SXM4 80GB (``BASELINE.md``):
~1.5 ms at ~1.7e6 dof and ~65 ms at 1e8 dof.

The likelihood is passed *as an argument* into the jitted metric so the
data array is a runtime input, not an inlined constant.  Each row is the
median wall time of single applies, each ended by ``block_until_ready``,
after a warm-up call.

Runs on a GPU only.  Emits one JSON line per configuration, each naming the
device and the card, plus a final composite line (geometric-mean speedup vs
the A100 baseline over the completed rows); exits non-zero if any row
failed.
"""

import json
import sys

import jax
import numpy as np
from jax import numpy as jnp
from jax import random

# (shape, baseline_ms, n_mode_knots).  n_mode_knots=None is the reference's
# exact unique-|k| spectrum (bit-parity model); an integer K puts the
# spectrum deviations on K log-spaced knots evaluated per pixel (gather-free;
# statistically equivalent prior — tests/test_knot_equivalence.py).
SIZES = [
    ((1280, 1280), 1.5, 64),
    ((1280, 1280), 1.5, None),
    ((4096, 4096), 12.0, 64),
    ((10240, 10240), 65.0, 64),
    ((4096, 4096), 12.0, None),
]
N_TIMED = 20


def _np_tree_like(shapes, rng):
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype)
        if jnp.issubdtype(s.dtype, jnp.floating)
        else np.zeros(s.shape, s.dtype),
        shapes,
    )


def build_likelihood(shape, n_mode_knots=None):
    """Poisson likelihood of exp(correlated field), position and tangent."""
    import nifty_tpu as nt

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        n_mode_knots=n_mode_knots,
    )
    cf = cfm.finalize()
    # ChainModel keeps cf's mode tables/distributor as dynamic pytree leaves
    # → they reach the compiled metric as runtime parameters, not inlined
    # constants
    fwd = nt.ChainModel(jnp.exp, cf)

    rng = np.random.default_rng(42)
    shapes = jax.eval_shape(cf.init, random.PRNGKey(0))
    pos_np = _np_tree_like(shapes, rng)
    # the Fisher metric is data-independent — synthetic counts suffice
    data = rng.poisson(1.0, size=shape).astype(np.int32)
    lh = nt.Poissonian(jnp.asarray(data)).amend(fwd)
    tangent_np = _np_tree_like(shapes, np.random.default_rng(44))
    pos = nt.Vector(jax.tree_util.tree_map(jax.device_put, pos_np))
    tangent = nt.Vector(jax.tree_util.tree_map(jax.device_put, tangent_np))
    return lh, pos, tangent


@jax.jit
def _metric(lh, p, t):
    return lh.metric(p, t)


def time_apply(lh, pos, tangent, n=N_TIMED):
    """Median seconds of single metric applies after a warm-up call."""
    from nifty_tpu.profiling import median_seconds

    return median_seconds(_metric, lh, pos, tangent, n=n)


def device_info():
    """The device as JAX reports it and the card as ``nvidia-smi`` does;
    refuses anything but a GPU."""
    from nifty_tpu.profiling import card_line, check_device

    dev = check_device(jax.devices())
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card_line(),
    }


def main():
    from nifty_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    ratios, names, failed = [], [], []
    for shape, baseline_ms, knots in SIZES:
        variant = "_exact" if knots is None else f"_knots{knots}"
        name = f"{shape[0]}x{shape[1]}{variant}"
        try:
            lh, pos, tangent = build_likelihood(shape, n_mode_knots=knots)
            t = time_apply(lh, pos, tangent)
        except Exception as e:  # noqa: BLE001 — report, finish the rows, fail
            print(f"bench: {name} failed ({e!r})", file=sys.stderr)
            failed.append(name)
            continue
        del lh, pos, tangent
        ratio = baseline_ms / (t * 1e3)
        ratios.append(ratio)
        names.append(name)
        print(
            json.dumps(
                {
                    "metric": f"cf2d_poisson_metric_apply_{name}",
                    "value": t * 1e3,
                    "unit": "ms",
                    "vs_baseline": ratio,
                    "device": device,
                }
            ),
            flush=True,
        )
    if ratios:
        geo = float(np.exp(np.mean(np.log(ratios))))
        print(
            json.dumps(
                {
                    "metric": "cf2d_poisson_metric_apply_geomean["
                    + ",".join(names)
                    + "]",
                    "value": geo,
                    "unit": "x_vs_A100_geomean",
                    "vs_baseline": geo,
                    "device": device,
                }
            ),
            flush=True,
        )
    if failed:
        raise SystemExit(f"bench: failed rows {failed}")


if __name__ == "__main__":
    main()
