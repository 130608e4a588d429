"""Config-file-driven inference: the OptimizeKLConfig driver.

Analogue of the reference demo
``demos/cl/getting_started_7_config_file.py``
(``nifty/cl/minimization/config/optimize_kl_config.py``): the whole VI
schedule — iteration counts, per-iteration sample numbers with ``N*K``
repetition syntax, sample modes, solver settings — lives in an ini file;
model builders are referenced from it by ``*name``.
"""

import os
import tempfile

import jax

if os.environ.get("NIFTY_TPU_DEMO_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")
if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)

import numpy as np
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt
from nifty_tpu.config_file import OptimizeKLConfig

CFG = """
[optimization]
output directory = {odir}

[base.opt]
sample mode = linear_resample
likelihood = *lh

[optimization.1]
base = base.opt
total iterations = 2
n samples = 2*2

[optimization.2]
base = base.opt
total iterations = 2
n samples = 3
sample mode = nonlinear_update
"""


def build_likelihood():
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (48,), distances=1.0 / 48, fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
    )
    cf = cfm.finalize()
    truth = cf(cf.init(random.PRNGKey(1)))
    data = truth + 0.1 * random.normal(random.PRNGKey(2), truth.shape)
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / 0.01).amend(cf)
    return lh, cf, truth


def main():
    lh, cf, truth = build_likelihood()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_file = os.path.join(tmp, "inference.cfg")
        with open(cfg_file, "w") as f:
            f.write(CFG.format(odir=os.path.join(tmp, "out")))

        cfg = OptimizeKLConfig.from_file(cfg_file, {"lh": lambda: lh})
        # the schedule: 4 total iterations, n_samples 2,2,3,3
        samples, state = cfg.optimize_kl(
            lh.init(random.PRNGKey(3)), key=random.PRNGKey(4)
        )
    assert state.nit == 4
    post = np.mean([np.asarray(cf(s)) for s in samples], axis=0)
    nrmse = np.linalg.norm(post - np.asarray(truth)) / np.linalg.norm(
        np.asarray(truth)
    )
    print(f"config-driven posterior NRMSE: {nrmse:.4f}")
    return nrmse


if __name__ == "__main__":
    nrmse = main()
    assert nrmse < 0.3
