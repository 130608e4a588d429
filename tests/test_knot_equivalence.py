"""Statistical equivalence of the knot (pixel-expansion) spectrum prior to
the reference-exact unique-|k| prior.

Both paths sample the *same* continuous integrated-Wiener-process
deviation curve in log|k|; the knot path merely evaluates it through
piecewise-linear interpolation on K log-spaced knots instead of at every
unique mode, so the only difference is the PWL interpolation error of an
IWP between knots — O(h^{3/2}) in the knot spacing h.  These tests
quantify that: at fixed hyperparameters the per-mode ln-amplitude mean
and std curves agree with the exact model at the Monte-Carlo noise floor
(≲3% in amplitude at S=1500 over curves spanning ~13 ln-units), and a
full VI run yields matching posterior moments.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt
from nifty_tpu.models.correlated_field import get_fourier_mode_distributor

jax.config.update("jax_enable_x64", True)

SHAPE = (128, 128)
DIST = (1.0 / SHAPE[0],) * 2


def _build(K, sharp_hypers=True):
    eps = 1e-8 if sharp_hypers else None
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(
        offset_mean=0.0,
        offset_std=(1.0, 1e-8) if sharp_hypers else (1e-1, 3e-2),
    )
    cfm.add_fluctuations(
        SHAPE,
        distances=DIST[0],
        fluctuations=(1.0, 1e-8) if sharp_hypers else (1.0, 5e-1),
        loglogavgslope=(-3.0, 1e-8) if sharp_hypers else (-3.0, 2e-1),
        flexibility=(1e0, 1e-8) if sharp_hypers else (1e0, 2e-1),
        n_mode_knots=K,
    )
    return cfm.finalize()


def _first_pixel_of_each_mode():
    idx, ul, cnt = get_fourier_mode_distributor(SHAPE, DIST)
    flat = idx.ravel()
    first = np.zeros(len(ul), np.int64)
    seen = np.zeros(len(ul), bool)
    for i, b in enumerate(flat):
        if not seen[b]:
            seen[b] = True
            first[b] = i
    return jnp.asarray(first), len(ul)


@pytest.mark.parametrize("K", [16, 64])
def test_knot_prior_amplitude_statistics_match_exact(K):
    """Mean and std of the per-mode ln normalized amplitude under the knot
    prior match the exact unique-|k| prior within MC error (S=1500)."""
    S = 1500
    first, M = _first_pixel_of_each_mode()
    cf_e = _build(None)
    cf_k = _build(K)

    def exact_curves(key):
        amp = cf_e.amplitudes[0]

        def one(k):
            p = cf_e.init(k)
            a = amp(p).at[1:].mul(1.0 / cf_e.azm(p))
            return jnp.log(a[1:])

        return jax.lax.map(one, random.split(key, S))

    def knot_curves(key):
        amp = cf_k.amplitudes[0]

        def one(k):
            p = cf_k.init(k)
            ea = amp.expanded_normalized(p, cf_k.azm(p))
            return jnp.log(ea.ravel()[first][1:])

        return jax.lax.map(one, random.split(key, S))

    C_e = np.asarray(exact_curves(random.PRNGKey(0)))
    C_k = np.asarray(knot_curves(random.PRNGKey(1)))
    m_e, s_e = C_e.mean(0), C_e.std(0)
    m_k, s_k = C_k.mean(0), C_k.std(0)

    # MC noise floor: std/sqrt(S) ~ 0.033 at the high-|k| end (std ≈ 1.3)
    assert np.abs(m_k - m_e).max() < 0.12
    assert np.abs(s_k - s_e).max() < 0.12
    assert np.sqrt(((m_k - m_e) ** 2).mean()) < 0.04


def test_knot_prior_field_variance_matches_exact():
    """Total prior field variance agrees between the paths (broad
    hyperpriors, S=256)."""
    S = 256
    cf_e = _build(None, sharp_hypers=False)
    cf_k = _build(64, sharp_hypers=False)

    def field_var(cf, key):
        f = jax.lax.map(lambda k: cf(cf.init(k)), random.split(key, S))
        return float(jnp.var(f))

    v_e = field_var(cf_e, random.PRNGKey(2))
    v_k = field_var(cf_k, random.PRNGKey(3))
    assert abs(v_k / v_e - 1.0) < 0.15


def test_knot_posterior_moments_match_exact():
    """Full MGVI runs with the exact and the K=64 knot prior on the same
    data produce matching posterior means/uncertainties (the justification
    for benchmarking the knot variant)."""
    shape = (64, 64)

    def build(K):
        cfm = nt.CorrelatedFieldMaker("cf")
        cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations(
            shape,
            distances=1.0 / shape[0],
            fluctuations=(1.0, 5e-1),
            loglogavgslope=(-3.0, 2e-1),
            flexibility=(1e0, 2e-1),
            n_mode_knots=K,
        )
        return cfm.finalize()

    cf_truth = build(None)
    pos_true = cf_truth.init(random.PRNGKey(10))
    truth = np.asarray(cf_truth(pos_true))
    rng = np.random.default_rng(11)
    data = jnp.asarray(truth + 0.2 * rng.normal(size=shape))

    def run(K):
        cf = build(K)
        lh = nt.Gaussian(data, noise_std_inv=lambda x: 5.0 * x).amend(cf)
        samples, _ = nt.optimize_kl(
            lh,
            jax.tree_util.tree_map(
                lambda x: 0.1 * x, cf.init(random.PRNGKey(0))
            ),
            n_total_iterations=4,
            n_samples=4,
            key=random.PRNGKey(12),
            draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=1e-6, maxiter=100)),
            kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-6, maxiter=20)),
            sample_mode="linear_resample",
            odir=None,
        )
        fields = np.stack([np.asarray(cf(s)) for s in samples])
        return fields.mean(0), fields.std(0)

    m_e, s_e = run(None)
    m_k, s_k = run(64)
    scale = np.maximum(s_e, 1e-3)
    assert np.max(np.abs(m_e - m_k) / scale) < 5.0
    assert abs(np.mean(m_e) - np.mean(m_k)) < 0.2
    assert 0.5 < (s_k.mean() / s_e.mean()) < 2.0
    # both reconstructions are close to the truth
    assert np.sqrt(np.mean((m_e - truth) ** 2)) < 0.3
    assert np.sqrt(np.mean((m_k - truth) ** 2)) < 0.3
