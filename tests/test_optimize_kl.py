"""optimize_kl driver: convergence, resume, and multi-device sample
sharding on the virtual CPU mesh."""

import os

import jax
import numpy as np
import pytest
from jax import numpy as jnp
from jax import random
from jax.sharding import NamedSharding

import nifty_tpu as nt


def _cf_problem(shape=(32,), seed=0, noise_std=0.1):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2))
    cf = cfm.finalize()
    truth = cf(cf.init(random.PRNGKey(seed)))
    data = truth + noise_std * random.normal(
        random.PRNGKey(seed + 1), truth.shape
    )
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(cf)
    return lh, cf, truth


def test_optimize_kl_converges_and_resumes(tmp_path):
    lh, cf, truth = _cf_problem()
    odir = os.path.join(tmp_path, "out")
    kwargs = dict(
        key=random.PRNGKey(2),
        n_total_iterations=3,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=32)),
        sample_mode="linear_resample",
        odir=odir,
    )
    samples, state = nt.optimize_kl(lh, nt.Vector(lh.init(random.PRNGKey(3))), **kwargs)
    assert state.nit == 3
    post = np.mean([np.asarray(cf(s)) for s in samples], axis=0)
    nrmse = np.linalg.norm(post - np.asarray(truth)) / np.linalg.norm(
        np.asarray(truth)
    )
    # measured 0.069 at 3 iterations (2x headroom); catches quality
    # regressions a loose bound would miss
    assert nrmse < 0.15
    # posterior must also be *calibrated*: per-pixel |error|/std neither
    # wildly overconfident (z >> 1) nor inflated (z << 0.05)
    pstd = np.std([np.asarray(cf(s)) for s in samples], axis=0)
    z = np.abs(post - np.asarray(truth)) / (pstd + 1e-12)
    assert 0.05 < np.median(z) < 3.0
    # resume continues from the checkpoint
    kwargs["n_total_iterations"] = 4
    samples2, state2 = nt.optimize_kl(lh, samples, resume=True, **kwargs)
    assert state2.nit == 4


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 devices")
def test_optimize_kl_sharded_samples():
    lh, cf, truth = _cf_problem()
    devices = jax.devices()[:4]
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(lh.init(random.PRNGKey(4))),
        key=random.PRNGKey(5),
        n_total_iterations=2,
        n_samples=2,  # mirrored -> 4 samples = mesh size
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=16)),
        sample_mode="linear_resample",
        devices=devices,
    )
    leaf = jax.tree_util.tree_leaves(samples._samples)[0]
    assert isinstance(leaf.sharding, NamedSharding)
    assert "samples" in leaf.sharding.spec
    assert len(samples) == 4
    assert np.all(np.isfinite(np.asarray(leaf)))


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 devices")
def test_optimize_kl_sharded_nonlinear():
    lh, cf, truth = _cf_problem(shape=(16,))
    devices = jax.devices()[:4]
    samples, state = nt.optimize_kl(
        lh,
        nt.Vector(lh.init(random.PRNGKey(6))),
        key=random.PRNGKey(7),
        n_total_iterations=2,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=16)),
        nonlinearly_update_kwargs=dict(
            minimize_kwargs=dict(maxiter=2, cg_kwargs=dict(maxiter=8))
        ),
        sample_mode="nonlinear_resample",
        devices=devices,
    )
    assert len(samples) == 4
    leaf = jax.tree_util.tree_leaves(samples._samples)[0]
    assert np.all(np.isfinite(np.asarray(leaf)))


def _vi_run(jit, cg_kwargs):
    """Two geoVI iterations with fixed short solver budgets: no stopping
    rule, and too few CG steps to reach the rounding floor, whose noise CG
    would amplify, so the jitted and the op-by-op run agree to rounding."""
    lh, cf, truth = _cf_problem(shape=(16,))
    opt = nt.OptimizeVI(lh, n_total_iterations=2, jit=jit)
    fixed_cg = dict(resnorm=-1.0, miniter=3, maxiter=3)
    newton = dict(xtol=-1.0, maxiter=2, energy_reduction_factor=0.0, cg_kwargs=fixed_cg)
    samples, _ = nt.optimize_kl(
        lh,
        nt.Vector(lh.init(random.PRNGKey(8))),
        key=random.PRNGKey(9),
        n_total_iterations=2,
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=cg_kwargs | dict(resnorm=-1.0)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=newton),
        kl_kwargs=dict(minimize_kwargs=newton),
        sample_mode="nonlinear_resample",
        _optimize_vi=opt,
    )
    return samples, opt


@pytest.mark.parametrize(
    "cg_kwargs, n_programs",
    [
        (dict(miniter=3, maxiter=3), 2),
        (dict(miniter=3, maxiter=3, absdelta=jnp.asarray(0.0)), 1),
    ],
)
def test_optimize_vi_compiles_each_sampling_phase_once(cg_kwargs, n_programs):
    """Jitted, both sampling phases are one program each, reused by every
    iteration (an unhashable option compiles per call instead), and they
    agree with the op-by-op run."""
    s_jit, opt = _vi_run(True, cg_kwargs)
    assert len(opt._programs) == n_programs
    s_eager, opt_eager = _vi_run(False, cg_kwargs)
    assert opt_eager._programs == {}
    for a, b in zip(
        jax.tree_util.tree_leaves(s_jit._samples),
        jax.tree_util.tree_leaves(s_eager._samples),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
