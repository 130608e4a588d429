"""Multi-grid GP: iterative charted refinement with a learned Matérn
kernel on a 2-D open grid.

Analogue of the reference's ``demos/re/a_icr.py``: the GP
never materializes a covariance over the fine grid — each refinement is
a batched stencil matmul — so the same model scales to 10⁸⁺ pixels.
"""

import os

import jax

if os.environ.get("NIFTY_TPU_DEMO_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")
if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)

import numpy as np
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt
from nifty_tpu.multi_grid import ICRField, MaternCovarianceModel, SimpleOpenGrid


def main():
    key = random.PRNGKey(21)
    grid = SimpleOpenGrid(shape0=(12, 12), depth=2, distances0=1.0, padding=1)
    print(f"grid levels: {grid.shapes}")

    matern = MaternCovarianceModel(
        ndim=2,
        r_min=0.05,
        r_max=20.0,
        scale=(1.0, 0.3),
        cutoff=(2.0, 0.5),
        loglogslope=(-3.5, 0.5),
        n_integrate=600,
        n_interpolate=128,
    )
    field = ICRField(grid, matern, offset=0.0)

    key, k_t, k_n, k_i, k_o = random.split(key, 5)
    truth_pos = field.init(k_t)
    truth = field(truth_pos)
    noise_std = 0.1 * float(jnp.std(truth))
    data = truth + noise_std * random.normal(k_n, truth.shape)
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(field)

    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(field.init(k_i)),
        key=k_o,
        n_total_iterations=3,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=48)),
        sample_mode="linear_resample",
    )
    post = np.stack([np.asarray(field(s)) for s in samples])
    nrmse = np.linalg.norm(post.mean(0) - np.asarray(truth)) / np.linalg.norm(
        np.asarray(truth)
    )
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    assert nrmse < 0.5, "ICR reconstruction failed"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
