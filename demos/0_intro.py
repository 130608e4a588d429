"""Getting started: 1-D correlated field + Gaussian likelihood, geoVI.

Analogue of the reference demo ``demos/re/0_intro.py``:
build a non-parametric correlated-field prior, generate synthetic data,
and run `optimize_kl` (MGVI/geoVI).
"""

import os

import jax

if os.environ.get("NIFTY_TPU_DEMO_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")
# f64 on CPU for exact parity checks; f32 on accelerators
if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)

import numpy as np
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt


def main():
    seed = 42
    key = random.PRNGKey(seed)

    dims = (128,)
    distances = 1.0 / dims[0]
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=2.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        dims,
        distances=distances,
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        asperity=(5e-1, 5e-2),
        prefix="ax1",
        non_parametric_kind="power",
    )
    correlated_field = cfm.finalize()

    class Signal(nt.Model):
        def __init__(self, cf):
            self.cf = cf
            super().__init__(init=cf.init)

        def __call__(self, x):
            return jnp.exp(self.cf(x))

    signal = Signal(correlated_field)

    key, sk = random.split(key)
    pos_truth = signal.init(sk)
    signal_truth = signal(pos_truth)

    key, sk = random.split(key)
    noise_cov = 0.1
    data = signal_truth + np.sqrt(noise_cov) * random.normal(
        sk, signal_truth.shape
    )

    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_cov).amend(signal)

    # NIFTY_TPU_DEMO_FAST=1 shrinks the VI schedule so the demo can run
    # unconditionally in CI; the default is the full reference-like run
    fast = os.environ.get("NIFTY_TPU_DEMO_FAST", "0") == "1"
    n_vi_iterations = 2 if fast else 4
    delta = 1e-4
    n_samples = 2 if fast else 4

    key, k_i, k_o = random.split(key, 3)
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(lh.init(k_i)),
        n_total_iterations=n_vi_iterations,
        n_samples=n_samples,
        key=k_o,
        draw_linear_kwargs=dict(
            cg_name=None,
            cg_kwargs=dict(absdelta=delta * 10.0, maxiter=100),
        ),
        nonlinearly_update_kwargs=dict(
            minimize_kwargs=dict(name=None, xtol=delta, maxiter=5)
        ),
        kl_kwargs=dict(minimize_kwargs=dict(name="M", xtol=delta, maxiter=35)),
        sample_mode="nonlinear_resample",
    )

    post_mean, post_std = nt.mean_and_std(tuple(signal(s) for s in samples))
    nrmse = float(
        np.sqrt(np.mean((post_mean - signal_truth) ** 2))
        / np.sqrt(np.mean(signal_truth**2))
    )
    inside = float(
        np.mean(np.abs(post_mean - signal_truth) < 3 * post_std + 1e-12)
    )
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    print(f"fraction of truth inside mean±3std: {inside:.3f}")
    assert nrmse < (0.3 if fast else 0.2), "reconstruction failed"
    return nrmse


if __name__ == "__main__":
    main()
