"""Non-parametric density estimation from event counts.

Analogue of the reference demo
``demos/cl/getting_started_density.py`` (``nifty/cl/sugar.py:230``
``density_estimator``): an exponentiated Matérn correlated field on a
padded grid is fit to binned samples with a Poisson likelihood.
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
    rng = np.random.default_rng(5)
    shape = (64,)
    n_events = 3000

    # ground-truth density: bimodal on [0, 1)
    xs = np.concatenate(
        [rng.normal(0.3, 0.06, n_events // 2), rng.normal(0.7, 0.1, n_events // 2)]
    )
    counts, _ = np.histogram(xs, bins=shape[0], range=(0.0, 1.0))

    model, pshape = nt.density_estimator(shape)
    unpad = tuple(slice(0, s) for s in shape)

    class Rate(nt.Model):
        def __init__(self, m):
            self.m = m
            super().__init__(init=m.init)

        def __call__(self, x):
            return self.m(x)[unpad]

    rate = Rate(model)
    lh = nt.Poissonian(jnp.asarray(counts.astype(np.int64))).amend(rate)

    key = random.PRNGKey(6)
    key, sub = random.split(key)
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(lh.init(sub)),
        key=key,
        n_total_iterations=4,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=50)),
        sample_mode="linear_resample",
        odir=None,
    )

    post = np.mean([np.asarray(rate(s)) for s in samples], axis=0)
    # compare shapes of the recovered and the empirical density
    emp = counts / counts.sum()
    rec = post / post.sum()
    l1 = float(np.abs(emp - rec).sum())
    print(f"density L1(empirical, recovered): {l1:.4f}")
    return l1


if __name__ == "__main__":
    l1 = main()
    assert l1 < 0.35
