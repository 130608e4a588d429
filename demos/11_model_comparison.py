"""Bayesian model comparison via the evidence lower bound (ELBO).

Analogue of the reference demo
``demos/cl/getting_started_model_comparison.py``
(``nifty/re/evidence_lower_bound.py:341``): fit two competing priors —
the correct smooth-spectrum model and an over-stiff one — to the same
data and rank them by the ELBO estimated from the converged
metric-Gaussian posteriors (deflated-Lanczos metric log-determinant).
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


def make_model(slope_mean, prefix):
    cfm = nt.CorrelatedFieldMaker(prefix)
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (64,), distances=1.0 / 64, fluctuations=(1.0, 3e-1),
        loglogavgslope=(slope_mean, 1e-1),
    )
    return cfm.finalize()


def fit(lh, key):
    k1, k2 = random.split(key)
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(lh.init(k1)),
        key=k2,
        n_total_iterations=4,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=64)),
        sample_mode="linear_resample",
        odir=None,
    )
    return samples


def main():
    key = random.PRNGKey(31)
    truth_model = make_model(-3.0, "m")
    key, sub = random.split(key)
    truth = truth_model(truth_model.init(sub))
    noise_std = 0.05
    key, sub = random.split(key)
    data = truth + noise_std * random.normal(sub, truth.shape, truth.dtype)
    nci = lambda x: x / noise_std**2

    elbos = {}
    for name, slope in [("matched (-3)", -3.0), ("stiff (-6)", -6.0)]:
        model = make_model(slope, "m")
        lh = nt.Gaussian(data, noise_cov_inv=nci).amend(model)
        key, sub = random.split(key)
        samples = fit(lh, sub)
        key, sub = random.split(key)
        _, stats = nt.estimate_evidence_lower_bound(
            lh, samples, 24, key=sub, verbose=False
        )
        elbos[name] = float(np.mean(np.asarray(stats["elbo_mean"])))
        print(f"ELBO[{name}] = {elbos[name]:.2f}")

    assert elbos["matched (-3)"] > elbos["stiff (-6)"], elbos
    print("model comparison prefers the matched prior — as it should")
    return elbos


if __name__ == "__main__":
    main()
