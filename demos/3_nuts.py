"""NUTS sampling of a correlated-field posterior (native adaptation).

Analogue of the reference's ``demos/re/a_nuts.py``: sample
the standardized posterior of a 1-D correlated-field model with the
built-in window-adaptation NUTS (no blackjax), chains vmapped.
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
    key = random.PRNGKey(33)
    dims = (64,)

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        dims, 1.0 / dims[0], (1.0, 5e-1), (-3.0, 2e-1), (1.0, 2e-1)
    )
    cf = cfm.finalize()

    key, k_t, k_n, k_s = random.split(key, 4)
    truth_pos = cf.init(k_t)
    truth = cf(truth_pos)
    noise_std = 0.2
    data = truth + noise_std * random.normal(k_n, truth.shape)
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(cf)

    samples, info = nt.nuts_sample(
        lh,
        k_s,
        n_chains=2,
        n_samples=300,
        n_warmup=200,
        max_tree_depth=8,
    )
    fields = np.stack([np.asarray(cf(s)) for s in samples])
    post_mean = fields.mean(axis=0)
    nrmse = np.linalg.norm(post_mean - np.asarray(truth)) / np.linalg.norm(
        np.asarray(truth)
    )
    acc = np.asarray(info["acceptance"])
    print(f"acceptance per chain: {np.round(acc, 3)}")
    print(f"divergences per chain: {np.asarray(info['divergences'])}")
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    assert np.all(acc > 0.4), "NUTS acceptance collapsed"
    assert nrmse < 0.8, "NUTS reconstruction failed"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
