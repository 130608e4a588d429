"""Parametric variational inference: mean-field and full-covariance ADVI.

Analogue of the reference demo
``demos/cl/getting_started_parametric_vi.py``
(``nifty/cl/library/variational_models.py``): a low-dimensional nonlinear
posterior is approximated by a diagonal-covariance and a full-covariance
Gaussian, optimized by stochastic gradient on the reparameterized ELBO
(optax Adam under one `lax.scan`).
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

    # a mildly nonlinear 8-dim regression model
    dim, ndata = 8, 32
    A = np.random.default_rng(0).standard_normal((ndata, dim)) / np.sqrt(dim)

    class Fwd(nt.Model):
        def __init__(self):
            super().__init__(
                init=nt.Initializer(
                    {"x": lambda k: random.normal(k, (dim,))}
                )
            )

        def __call__(self, p):
            x = p["x"] if not hasattr(p, "tree") else p.tree["x"]
            return jnp.tanh(A @ x)

    fwd = Fwd()
    key, sub = random.split(key)
    truth = fwd(fwd.init(sub))
    noise_std = 0.05
    key, sub = random.split(key)
    data = truth + noise_std * random.normal(sub, truth.shape, truth.dtype)
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(fwd)

    pos0 = lh.init(random.PRNGKey(0))

    key, k1, k2 = random.split(key, 3)
    mf = nt.MeanFieldVI(lh, pos0, n_samples=4)
    mf.fit(k1, n_steps=600)
    fc = nt.FullCovarianceVI(lh, pos0, n_samples=4)
    fc.fit(k2, n_steps=600)

    # the full-covariance family contains the mean-field one: its final
    # ELBO loss must not be (significantly) worse
    key, k3, k4 = random.split(key, 3)
    mf_loss = float(mf.loss(mf.params, k3))
    fc_loss = float(fc.loss(fc.params, k4))
    print(f"negative-ELBO  mean-field: {mf_loss:.2f}  full-cov: {fc_loss:.2f}")

    for name, vi in [("mean-field", mf), ("full-cov", fc)]:
        post_mean = np.asarray(fwd(vi.mean))
        nrmse = np.linalg.norm(post_mean - np.asarray(truth)) / np.linalg.norm(
            np.asarray(truth)
        )
        print(f"{name} posterior-mean NRMSE: {nrmse:.4f}")
    return mf_loss, fc_loss


if __name__ == "__main__":
    mf_loss, fc_loss = main()
    assert fc_loss < mf_loss + 5.0
