"""float32 (accelerator-default precision) validation lane.

The rest of the suite runs in x64 to separate algorithmic bugs from
rounding; accelerators run float32 by default.  These tests re-run
the core identities and an end-to-end inference in float32 with
float32-realistic tolerances — the mixed-precision strategy check of
SURVEY §7 hard part (f).  Select with ``pytest -k f32``.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt


@pytest.fixture()
def f32():
    with jax.enable_x64(False):
        yield


def _build_cf(shape=(24, 24), K=None):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.2, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        n_mode_knots=K,
    )
    return cfm.finalize()


def test_f32_likelihood_metric_identities(f32):
    """metric ≡ lsm∘rsm and rsm ≡ lsmᵀ hold at f32 rounding."""
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.normal(size=(12,)).astype(np.float32))
    lh = nt.Gaussian(data, noise_std_inv=lambda x: 2.0 * x).amend(
        lambda x: jnp.exp(x)
    )
    p = jnp.asarray(rng.normal(size=(12,)).astype(np.float32) * 0.3)
    t = jnp.asarray(rng.normal(size=(12,)).astype(np.float32))
    assert lh.energy(p).dtype == jnp.float32
    met = lh.metric(p, t)
    lsm_rsm = lh.left_sqrt_metric(p, lh.right_sqrt_metric(p, t))
    np.testing.assert_allclose(
        np.asarray(met), np.asarray(lsm_rsm), rtol=2e-5, atol=2e-5
    )


def test_f32_cf_forward_matches_x64():
    """The f32 correlated-field forward agrees with the x64 evaluation to
    f32 rounding (no catastrophic cancellation in the folded expansion,
    normalization sums, or Hartley)."""
    cf = _build_cf((32, 18))
    pos64 = cf.init(random.PRNGKey(1))
    out64 = np.asarray(cf(pos64))
    with jax.enable_x64(False):
        pos32 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float32)), pos64
        )
        out32 = np.asarray(cf(pos32))
        assert out32.dtype == np.float32
    scale = np.abs(out64).max()
    np.testing.assert_allclose(out32, out64, atol=3e-5 * scale)


def test_f32_static_cg_converges(f32):
    """static CG solves the (metric+1) system at f32 with resnorm-level
    accuracy."""
    cf = _build_cf((16, 16))
    data = jnp.asarray(
        np.random.default_rng(2).normal(size=(16, 16)).astype(np.float32)
    )
    lh = nt.Gaussian(data, noise_std_inv=lambda x: 3.0 * x).amend(cf)
    pos = cf.init(random.PRNGKey(2))
    probe = cf.init(random.PRNGKey(3))

    def met(x):
        return jax.tree_util.tree_map(jnp.add, lh.metric(pos, x), x)

    res = nt.static_cg(met, probe, resnorm=1e-3, maxiter=200)
    r = jax.tree_util.tree_map(
        lambda a, b: a - b, met(res.x), probe
    )
    rnorm = float(
        jnp.sqrt(
            sum(jnp.sum(l**2) for l in jax.tree_util.tree_leaves(r))
        )
    )
    assert rnorm < 5e-3


def test_f32_hartley_roundtrip(f32):
    from nifty_tpu.ops.fft import hartley

    x = jnp.asarray(
        np.random.default_rng(3).normal(size=(48, 32)).astype(np.float32)
    )
    twice = hartley(hartley(x))
    np.testing.assert_allclose(
        np.asarray(twice), np.asarray(x) * x.size, rtol=3e-4, atol=1e-3
    )


def test_f32_sht_matches_x64():
    from nifty_tpu.ops.sht import get_healpix_synthesis

    nside, lmax = 4, 8
    n_alm = (lmax + 1) ** 2
    alm64 = jnp.asarray(np.random.default_rng(4).normal(size=(n_alm,)))
    syn = get_healpix_synthesis(nside=nside, axis=0, lmax=lmax, mmax=lmax)
    ref = np.asarray(syn(alm64))
    with jax.enable_x64(False):
        alm32 = jnp.asarray(np.asarray(alm64, np.float32))
        syn32 = get_healpix_synthesis(nside=nside, axis=0, lmax=lmax, mmax=lmax)
        out = np.asarray(syn32(alm32))
        assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=2e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("nside", [64, 128])
def test_f32_sht_matches_x64_near_poles(nside):
    """float32 synthesis at nside where the Legendre seeds sin^m θ leave
    the float32 range and 1 − cos θ rounds away on the polar rings (the
    scaled recurrence and the polar step in ``ops/sht.py``); the plain
    float32 recurrence is off by 0.13 at nside 128."""
    from nifty_tpu.ops.sht import healpix_synthesis

    lmax = 2 * nside
    syn = jax.jit(lambda a: healpix_synthesis(a, nside, lmax, lmax))
    alm = np.random.default_rng(2).standard_normal((lmax + 1) ** 2)
    ref = np.asarray(syn(jnp.asarray(alm)))
    with jax.enable_x64(False):
        out = np.asarray(syn(jnp.asarray(alm, jnp.float32)))
    assert out.dtype == np.float32
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 5e-5, err


def test_f32_optimize_kl_end_to_end(f32):
    """Full MGVI inference at f32: reconstruction error comparable to the
    x64 behavior (posterior mean close to the truth)."""
    shape = (32, 32)
    cf = _build_cf(shape)
    pos_true = cf.init(random.PRNGKey(5))
    truth = np.asarray(cf(pos_true))
    data = jnp.asarray(
        (truth + 0.1 * np.random.default_rng(6).normal(size=shape)).astype(
            np.float32
        )
    )
    lh = nt.Gaussian(data, noise_std_inv=lambda x: 10.0 * x).amend(cf)
    samples, state = nt.optimize_kl(
        lh,
        jax.tree_util.tree_map(lambda x: 0.1 * x, cf.init(random.PRNGKey(0))),
        n_total_iterations=3,
        n_samples=2,
        key=random.PRNGKey(7),
        draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=1e-4, maxiter=60)),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=15)),
        sample_mode="linear_resample",
        odir=None,
    )
    mean = np.mean(
        np.stack([np.asarray(cf(s)) for s in samples]), axis=0
    )
    assert mean.dtype == np.float32
    nrmse = np.sqrt(np.mean((mean - truth) ** 2)) / np.sqrt(
        np.mean(truth**2)
    )
    assert nrmse < 0.35


def test_f32_knot_metric_finite_and_symmetric(f32):
    """The knot-path metric at f32: symmetric (⟨t1,M t2⟩=⟨M t1,t2⟩) and
    finite — the custom fused pull-back does not lose precision."""
    cf = _build_cf((64, 64), K=16)
    data = jnp.asarray(
        np.random.default_rng(8).poisson(1.0, (64, 64)).astype(np.int32)
    )
    lh = nt.Poissonian(data).amend(nt.ChainModel(jnp.exp, cf))
    pos = cf.init(random.PRNGKey(8))
    t1 = cf.init(random.PRNGKey(9))
    t2 = cf.init(random.PRNGKey(10))
    m1 = lh.metric(pos, t1)
    m2 = lh.metric(pos, t2)
    d1 = sum(
        float(jnp.vdot(a, b))
        for a, b in zip(
            jax.tree_util.tree_leaves(m1), jax.tree_util.tree_leaves(t2)
        )
    )
    d2 = sum(
        float(jnp.vdot(a, b))
        for a, b in zip(
            jax.tree_util.tree_leaves(t1), jax.tree_util.tree_leaves(m2)
        )
    )
    assert np.isfinite(d1) and np.isfinite(d2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4)
