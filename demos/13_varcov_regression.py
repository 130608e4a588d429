"""Heteroscedastic regression with a learnable full noise covariance.

Analogue of the reference demo
``demos/re/a_NDVariableCovarianceGaussian.py``
(``nifty/re/likelihood_impl.py:376``): jointly infer a smooth signal and
a per-datum 2x2 noise covariance whose correlation and scale vary along
the axis.  The matrix square roots / inverses inside the likelihood run
through the spectral tree-linalg machinery
(`nifty_tpu/utils/tree_linalg.py`, Daleckii–Krein JVPs).
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
    key = random.PRNGKey(51)
    n, d = 96, 2

    cfm = nt.CorrelatedFieldMaker("sig")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (n,), distances=1.0 / n, fluctuations=(1.0, 3e-1),
        loglogavgslope=(-3.5, 2e-1),
    )
    signal = cfm.finalize()

    class MeanAndCov(nt.Model):
        """(mean, cov) model: both channels share the smooth signal; the
        noise covariance is built from a latent lower-triangular sqrt."""

        def __init__(self, sig):
            self.sig = sig
            extra = nt.Initializer(
                {"nsqrt": lambda k: 0.1 * random.normal(k, (n, d, d))}
            )
            super().__init__(init=sig.init | extra)

        def __call__(self, x):
            p = x.tree if hasattr(x, "tree") else x
            s = self.sig(p)
            mean = jnp.stack([s, -0.5 * s], axis=-1)  # (n, d)
            m = p["nsqrt"]
            cov = jnp.einsum("...ij,...kj->...ik", m, m) + 0.05 * jnp.eye(d)
            return (mean, cov)

    fwd = MeanAndCov(signal)

    key, sub = random.split(key)
    mean_t, cov_t = fwd(fwd.init(sub))
    key, sub = random.split(key)
    chol = np.linalg.cholesky(np.asarray(cov_t))
    eps = np.asarray(random.normal(sub, (n, d)))
    data = np.asarray(mean_t) + np.einsum("nij,nj->ni", chol, eps)

    lh = nt.NDVariableCovarianceGaussian(jnp.asarray(data)).amend(fwd)

    key, k1, k2 = random.split(key, 3)
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

    post = np.mean([np.asarray(fwd(s)[0]) for s in samples], axis=0)
    nrmse = np.linalg.norm(post - np.asarray(mean_t)) / np.linalg.norm(
        np.asarray(mean_t)
    )
    print(f"heteroscedastic posterior-mean NRMSE: {nrmse:.4f}")
    return nrmse


if __name__ == "__main__":
    nrmse = main()
    assert nrmse < 0.6
