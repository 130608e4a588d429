"""Wiener filter: the exact Gaussian posterior for a linear model.

Analogue of the reference demo ``demos/re/a_wiener_filter.py``:
known covariance, masked data, CG-solved posterior mean and samples.
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
from nifty_tpu.ops.fft import hartley


def main():
    key = random.PRNGKey(12)
    dims = (128,)
    dist = 1.0 / dims[0]

    # fixed power-law covariance: S = HT diag(p(k)) HT^T
    from nifty_tpu.models.correlated_field import get_fourier_mode_distributor

    p_idx, k_uniq, _ = get_fourier_mode_distributor(dims, dist)
    power = 50.0 * np.where(
        k_uniq > 0, 1.0 / (1.0 + (k_uniq / 8.0) ** 2) ** 2, 1.0
    )
    amp = np.sqrt(power)[np.asarray(p_idx)]

    def signal(x):
        return hartley(jnp.asarray(amp) * x) / dims[0]

    # mask one third of the pixels
    mask = np.ones(dims)
    mask[dims[0] // 3 : dims[0] // 2] = 0.0

    def response(x):
        return jnp.asarray(mask) * signal(x)

    key, k_t, k_n, k_s = random.split(key, 4)
    truth_xi = random.normal(k_t, dims)
    truth = signal(truth_xi)
    noise_std = 0.02
    data = np.asarray(mask) * (
        np.asarray(truth) + noise_std * np.asarray(random.normal(k_n, dims))
    )

    lh = nt.Gaussian(
        jnp.asarray(data), noise_cov_inv=lambda x: x / noise_std**2
    ).amend(response, domain=jnp.zeros(dims))

    samples, info = nt.wiener_filter_posterior(
        lh,
        key=k_s,
        n_samples=8,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=200)),
    )
    post_mean = np.asarray(signal(samples.pos))
    obs = mask > 0
    nrmse = np.linalg.norm((post_mean - np.asarray(truth))[obs]) / np.linalg.norm(
        np.asarray(truth)[obs]
    )
    print(f"posterior NRMSE vs truth (observed region): {nrmse:.4f}")
    smpl_fields = np.stack([np.asarray(signal(s)) for s in samples])
    band = smpl_fields.std(0)
    # masked region carries larger posterior uncertainty
    print(
        f"mean posterior std observed/masked: "
        f"{band[obs].mean():.4f} / {band[~obs].mean():.4f}"
    )
    assert nrmse < 0.3
    assert band[~obs].mean() > 2.0 * band[obs].mean()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
