"""Binary classification of a spatial field: Bernoulli likelihood.

Analogue of the reference demo
``demos/cl/getting_started_3.py``'s Bernoulli variant
(``nifty/cl/operators/energy_operators.py:749``): a correlated field is
squashed through a sigmoid into per-pixel event probabilities; the data
are binary draws.
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
    key = random.PRNGKey(21)
    shape = (64, 64)

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(2.0, 5e-1),
        loglogavgslope=(-4.0, 2e-1),
    )
    cf = cfm.finalize()
    prob = nt.ChainModel(jax.nn.sigmoid, cf)

    key, sub = random.split(key)
    p_truth = prob(prob.init(sub))
    key, sub = random.split(key)
    data = random.bernoulli(sub, np.asarray(p_truth)).astype(np.int8)

    lh = nt.Bernoulli(jnp.asarray(data)).amend(prob)

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

    p_post = np.mean([np.asarray(prob(s)) for s in samples], axis=0)
    # Brier skill vs the constant-rate baseline
    d = np.asarray(data, dtype=np.float64)
    brier = np.mean((p_post - d) ** 2)
    base = np.mean((d.mean() - d) ** 2)
    skill = 1.0 - brier / base
    print(f"Brier skill score vs constant baseline: {skill:.4f}")
    return skill


if __name__ == "__main__":
    skill = main()
    assert skill > 0.1
