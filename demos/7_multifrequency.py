"""Multifrequency imaging: batched correlated fields + RGB rendering.

Analogue of the reference demo ``demos/cl/getting_started_5_mf.py``
(dofdex-style multifrequency correlated fields,
``nifty/cl/library/correlated_fields.py:659``): here the frequency axis is a
`VModel` vmap over per-channel excitations with a *shared* spectrum — the
idiomatic JAX batching of what cl implements with dofdex index lists.  The
posterior mean cube is rendered to sRGB with the colorimetric pipeline
(`nifty_tpu.plot.rgb_from_spectral_cube`, ref ``nifty/cl/plot.py:64``).
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
    key = random.PRNGKey(11)
    nfreq, shape = 4, (48, 48)

    cfm = nt.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.5, 2e-1),
    )
    cf = cfm.finalize()
    # batch the whole model over the frequency axis: each channel gets its
    # own excitations, the spectrum hyperparameters are shared via the
    # vmapped init (reference's total_N/dofdex machinery, JAX-style)
    mf = nt.VModel(cf, axis_size=nfreq)
    sky = nt.ChainModel(jnp.exp, mf)

    key, sub = random.split(key)
    truth = sky(sky.init(sub))
    key, sub = random.split(key)
    noise_std = 0.3
    data = truth + noise_std * random.normal(sub, truth.shape, truth.dtype)

    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(sky)

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

    mean = np.mean([np.asarray(sky(s)) for s in samples], axis=0)
    nrmse = np.linalg.norm(mean - np.asarray(truth)) / np.linalg.norm(
        np.asarray(truth)
    )
    print(f"multifrequency posterior NRMSE: {nrmse:.4f}")

    rgb = nt.plot.rgb_from_spectral_cube(mean)
    assert rgb.shape == shape + (3,) and np.all((rgb >= 0) & (rgb <= 1))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(1, 2, figsize=(8, 4))
        axs[0].imshow(nt.plot.rgb_from_spectral_cube(np.asarray(truth)))
        axs[0].set_title("truth (RGB)")
        axs[1].imshow(rgb)
        axs[1].set_title("posterior mean (RGB)")
        fig.savefig("multifrequency_rgb.png", dpi=120)
        print("wrote multifrequency_rgb.png")
    except ImportError:
        pass
    return nrmse


if __name__ == "__main__":
    nrmse = main()
    assert nrmse < 0.5
