"""Tomography: line-of-sight integrals through a 2-D correlated field.

Analogue of the reference demo ``demos/re/1_tomography.py``:
reconstruct a log-density field from noisy LOS integrals with MGVI.
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


def main():
    key = random.PRNGKey(41)
    shape = (64, 64)
    distances = (1.0 / shape[0], 1.0 / shape[1])

    cfm = nt.CorrelatedFieldMaker("rho")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=distances,
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-4.0, 2e-1),
        flexibility=(8e-1, 2e-1),
    )
    cf = cfm.finalize()

    # random rays from the boundary through the unit square
    n_rays = 256
    key, k1, k2 = random.split(key, 3)
    start = np.stack(
        [np.zeros(n_rays), np.asarray(random.uniform(k1, (n_rays,)))], axis=1
    )
    end = np.stack(
        [np.ones(n_rays), np.asarray(random.uniform(k2, (n_rays,)))], axis=1
    )
    # response: exact ray-cell traversal (reference LOSResponse analogue)
    # or dense point sampling — NIFTY_TPU_LOS=sampling|exact
    if os.environ.get("NIFTY_TPU_LOS", "exact") == "exact":
        los = nt.ExactGridLOS(start, end, shape=shape, distances=distances)
    else:
        los = nt.SamplingCartesianGridLOS(
            start, end, shape=shape, distances=distances,
            n_sampling_points=256,
        )

    class Forward(nt.Model):
        def __init__(self, cf, los):
            self.cf = cf
            self.los = los
            super().__init__(init=cf.init)

        def __call__(self, x):
            return self.los(jnp.exp(self.cf(x)))

    fwd = Forward(cf, los)

    key, k_truth, k_noise = random.split(key, 3)
    truth_pos = fwd.init(k_truth)
    truth_line = fwd(truth_pos)
    noise_std = 1e-2 * float(jnp.mean(truth_line))
    data = truth_line + noise_std * random.normal(k_noise, truth_line.shape)

    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(fwd)

    key, k_opt, k_init = random.split(key, 3)
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(fwd.init(k_init)),
        key=k_opt,
        n_total_iterations=4,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=64)),
        sample_mode="linear_resample",
    )

    truth_field = np.exp(np.asarray(cf(truth_pos)))
    post_fields = np.stack([np.exp(np.asarray(cf(s))) for s in samples])
    post_mean = post_fields.mean(axis=0)
    nrmse = np.linalg.norm(post_mean - truth_field) / np.linalg.norm(truth_field)
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    assert nrmse < 0.6, "tomography reconstruction failed"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
