"""All-sky inference: correlated field on the HEALPix sphere.

Exercises the plain-XLA spherical-harmonic synthesis (no ducc0): fit a
spherical correlated field to noisy pixel data with MGVI and render a
Mollweide view.
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
    key = random.PRNGKey(7)
    nside = 16

    cfm = nt.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (nside,),
        distances=None,
        fluctuations=(1.0, 0.5),
        loglogavgslope=(-3.0, 0.5),
        flexibility=(1.0, 0.3),
        harmonic_type="spherical",
    )
    sky = cfm.finalize()

    key, k_truth, k_noise, k_init, k_opt = random.split(key, 5)
    truth_pos = sky.init(k_truth)
    truth = sky(truth_pos)
    noise_std = 0.3 * float(jnp.std(truth))
    data = truth + noise_std * random.normal(k_noise, truth.shape)

    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(sky)
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(sky.init(k_init)),
        key=k_opt,
        n_total_iterations=3,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=48)),
        sample_mode="linear_resample",
    )

    post = np.stack([np.asarray(sky(s)) for s in samples])
    post_mean, post_std = post.mean(0), post.std(0)
    nrmse = np.linalg.norm(post_mean - np.asarray(truth)) / np.linalg.norm(
        np.asarray(truth)
    )
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")

    if os.environ.get("NIFTY_TPU_DEMO_PLOT", "0") == "1":
        from nifty_tpu.plot import Plot

        p = Plot()
        p.add(np.asarray(truth), title="truth")
        p.add(np.asarray(data), title="data")
        p.add(post_mean, title="posterior mean")
        p.add(post_std, title="posterior std")
        p.output(name="sphere_demo.png")
    assert nrmse < 0.7, "spherical reconstruction failed"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
