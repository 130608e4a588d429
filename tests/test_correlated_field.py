"""Correlated-field model tests: mode binning, Hartley identities,
amplitude normalization, and prior statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import random

import nifty_tpu as nt
from nifty_tpu.ops.fft import hartley


@pytest.mark.parametrize("shape", [(8,), (8, 6), (4, 4, 4)])
def test_hartley_self_inverse(shape):
    x = np.random.default_rng(0).normal(size=shape)
    h = hartley(jnp.asarray(x))
    hh = hartley(h)
    np.testing.assert_allclose(hh, np.prod(shape) * x, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", [(8,), (8, 6), (5, 7)])
def test_hartley_matches_fftn_formula(shape):
    x = np.random.default_rng(1).normal(size=shape)
    ft = np.fft.fftn(x)
    expected = ft.real - ft.imag
    np.testing.assert_allclose(hartley(jnp.asarray(x)), expected, rtol=1e-10, atol=1e-10)


def test_hartley_self_adjoint():
    shape = (8, 6)
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=shape), rng.normal(size=shape)
    lhs = np.vdot(np.asarray(hartley(jnp.asarray(a))), b)
    rhs = np.vdot(a, np.asarray(hartley(jnp.asarray(b))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_fourier_mode_distributor():
    idx, um, cnt = nt.get_fourier_mode_distributor((8, 8), (1.0 / 8, 1.0 / 8))
    assert idx.shape == (8, 8)
    assert um[0] == 0.0
    assert cnt[0] == 1  # unique zero mode
    assert cnt.sum() == 64
    # index array must address every unique mode
    assert set(np.unique(idx)) == set(range(len(um)))
    # mode lengths increase
    assert np.all(np.diff(um) > 0)


def test_spherical_mode_distributor():
    (idx, um, cnt), (lmax, mmax, size) = nt.get_spherical_mode_distributor(4)
    assert lmax == 8 and mmax == 8
    assert size == (lmax + 1) ** 2
    assert um.tolist() == list(range(lmax + 1))
    # multiplicity of l: 2l+1 (m=0 once, m>0 twice as re/im pairs)
    np.testing.assert_array_equal(cnt, [2 * l + 1 for l in range(lmax + 1)])
    assert idx.shape == (size,)


def _simple_cf(shape=(64,), offset_std=(1e-3, 1e-6), fluct=(1.0, 1e-6),
               slope=(-2.0, 1e-6), **kw):
    cfm = nt.CorrelatedFieldMaker("t")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=offset_std)
    cfm.add_fluctuations(
        shape, distances=1.0 / shape[0], fluctuations=fluct,
        loglogavgslope=slope, **kw,
    )
    return cfm.finalize()


def test_cf_domain_and_shapes():
    cf = _simple_cf(flexibility=(1.0, 0.1), asperity=(0.5, 0.05))
    dom = cf.domain
    for k in ("txi", "tzeromode", "tfluctuations", "tloglogavgslope",
              "tflexibility", "tasperity", "tspectrum"):
        assert k in dom, k
    out = cf(cf.init(random.PRNGKey(0)))
    assert out.shape == (64,)


def test_cf_prior_std_matches_fluctuations():
    """With tight hyper-priors, the field std must match `fluctuations`."""
    fluct_val = 1.7
    cf = _simple_cf(shape=(64,), fluct=(fluct_val, 1e-6))
    n = 300
    keys = random.split(random.PRNGKey(1), n)
    draw = jax.jit(jax.vmap(lambda k: cf(cf.init(k))))
    fields = np.asarray(draw(keys))
    total_std = np.sqrt(np.mean(np.var(fields, axis=1)))
    # MC tolerance
    assert abs(total_std - fluct_val) / fluct_val < 0.15, total_std


def test_cf_offset_mean():
    cfm = nt.CorrelatedFieldMaker("t")
    cfm.set_amplitude_total_offset(offset_mean=5.0, offset_std=(1e-4, 1e-8))
    cfm.add_fluctuations((32,), 1.0 / 32, (1e-4, 1e-8), (-2.0, 1e-8))
    cf = cfm.finalize()
    out = cf(cf.init(random.PRNGKey(0)))
    np.testing.assert_allclose(out, 5.0, atol=1e-2)


def test_cf_2d_and_outer_product():
    cfm = nt.CorrelatedFieldMaker("t")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1.0, 0.5))
    cfm.add_fluctuations((8,), 1.0 / 8, (1.0, 0.5), (-2.0, 0.2), prefix="a")
    cfm.add_fluctuations((6,), 1.0 / 6, (1.0, 0.5), (-2.0, 0.2), prefix="b")
    cf = cfm.finalize()
    assert cf.domain["txi"].shape == (8, 6)
    out = cf(cf.init(random.PRNGKey(0)))
    assert out.shape == (8, 6)
    assert np.all(np.isfinite(np.asarray(out)))


def test_matern_amplitude():
    cfm = nt.CorrelatedFieldMaker("t")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1.0, 0.5))
    cfm.add_fluctuations_matern(
        (32,), 1.0 / 32, scale=(1.0, 0.3), cutoff=(1.0, 0.1),
        loglogslope=(-4.0, 0.5), renormalize_amplitude=True,
    )
    cf = cfm.finalize()
    out = cf(cf.init(random.PRNGKey(0)))
    assert out.shape == (32,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_gauss_markov_wiener_stats():
    """WP increments must be N(0, sigma^2 dt)."""
    n, dt, sigma = 2000, 0.5, 1.3
    xi = np.asarray(random.normal(random.PRNGKey(0), (n,)))
    wp = np.asarray(nt.wiener_process(jnp.asarray(xi), 0.0, sigma, dt))
    incr = np.diff(wp)
    assert abs(np.std(incr) - sigma * np.sqrt(dt)) < 0.05


def test_gauss_markov_ou_stationary():
    """OU stationary std must equal sigma."""
    n, dt, sigma, gamma = 4000, 0.1, 0.7, 1.0
    xi = np.asarray(random.normal(random.PRNGKey(1), (n,)))
    x0 = 0.7  # start at stationary scale
    ou = np.asarray(
        nt.ornstein_uhlenbeck_process(jnp.asarray(xi), x0, sigma, gamma, dt)
    )
    assert abs(np.std(ou[100:]) - sigma) < 0.1


def test_integrated_wiener_process_shape():
    xi = random.normal(random.PRNGKey(2), (10, 2))
    out = nt.integrated_wiener_process(xi, jnp.zeros(2), 1.0, 0.5)
    assert out.shape == (11, 2)
    # second column is a plain Wiener process (cumsum)
    np.testing.assert_allclose(
        np.asarray(out[1:, 1]),
        np.cumsum(np.asarray(xi[:, 1])) * 1.0 * np.sqrt(0.5),
        rtol=1e-10,
    )


# --- pixel-expansion (gather-free) amplitudes --------------------------------


def _build_cf(shape, n_mode_knots=None, flexibility=None):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(1.0, (1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        1.0 / shape[0],
        (1.0, 0.5),
        (-3.0, 0.2),
        flexibility=flexibility,
        n_mode_knots=n_mode_knots,
    )
    return cfm.finalize()


@pytest.mark.parametrize("shape", [(16,), (24, 24), (8, 8, 8)])
def test_pixel_mode_matches_exact_for_power_law(shape):
    """Without spectrum deviations the pixel path is the same function as
    the unique-mode table path — they must agree to machine precision."""
    cf_e = _build_cf(shape)
    cf_p = _build_cf(shape, n_mode_knots=16)
    p = cf_e.init(random.PRNGKey(0))
    np.testing.assert_allclose(
        np.asarray(jax.jit(cf_e)(p)),
        np.asarray(jax.jit(cf_p)(p)),
        rtol=1e-12,
        atol=1e-12,
    )


def test_knot_mode_runs_with_deviations():
    cf = _build_cf((24, 24), n_mode_knots=12, flexibility=(1.0, 0.3))
    assert cf.domain["cfspectrum"].shape == (11, 2)
    p = cf.init(random.PRNGKey(1))
    out = jax.jit(cf)(p)
    assert np.all(np.isfinite(np.asarray(out)))
    g = jax.grad(lambda q: jnp.sum(cf(q) ** 2))(p)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_knot_mode_field_std_calibrated():
    """`fluctuations` must set the prior field std also on the knot path."""
    cf = _build_cf((32, 32), n_mode_knots=16, flexibility=(1.0, 0.2))
    keys = random.split(random.PRNGKey(2), 64)
    draw = jax.jit(jax.vmap(lambda k: cf(cf.init(k))))
    smpls = np.asarray(draw(keys))
    # offset-subtracted std over samples and pixels ~ fluctuations mean
    std = np.std(smpls - 1.0)
    assert 0.4 < std < 2.5


def test_knot_mode_metric_and_sampling():
    cf = _build_cf((24, 24), n_mode_knots=12, flexibility=(1.0, 0.3))
    lh = nt.Gaussian(
        jnp.zeros((24, 24)), noise_cov_inv=lambda x: x * 4.0
    ).amend(cf)
    pos = nt.Vector(lh.init(random.PRNGKey(3)))
    t = nt.Vector(lh.init(random.PRNGKey(4)))
    m = jax.jit(lambda l, p, x: l.metric(p, x))(lh, pos, t)
    for leaf in jax.tree_util.tree_leaves(m):
        assert np.all(np.isfinite(np.asarray(leaf)))
    smpl, info = jax.jit(
        lambda l, p, k: nt.draw_linear_residual(l, p, k, cg_kwargs=dict(maxiter=10))
    )(lh, pos, random.PRNGKey(5))
    for leaf in jax.tree_util.tree_leaves(smpl):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_matern_pixel_expansion_matches_table():
    def build(pixel):
        cfm = nt.CorrelatedFieldMaker("m")
        cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
        cfm.add_fluctuations_matern(
            (24, 24),
            1.0 / 24,
            scale=(1.0, 0.3),
            cutoff=(1.0, 0.5),
            loglogslope=(-3.0, 0.3),
            renormalize_amplitude=True,
            pixel_expansion=pixel,
        )
        return cfm.finalize()

    cf_t = build(False)
    cf_p = build(True)
    p = cf_t.init(random.PRNGKey(6))
    np.testing.assert_allclose(
        np.asarray(jax.jit(cf_t)(p)),
        np.asarray(jax.jit(cf_p)(p)),
        rtol=1e-10,
        atol=1e-10,
    )


@pytest.mark.parametrize("shape", [(16,), (17,), (16, 12), (15, 9), (8, 6, 10)])
def test_folded_distributor_exactness(shape):
    """The mirror-folded power distributor (gather on the (n//2+1)^d core +
    mirror expansion) is bit-identical to the full-table gather — the |k|
    grid is invariant under reversing any axis."""
    from nifty_tpu.models.correlated_field import _mirror_unfold

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
    )
    cf = cfm.finalize()
    pos = cf.init(random.PRNGKey(3))
    g = cf.target_grids[0]
    pd = np.asarray(g.harmonic_grid.power_distributor)
    azm = cf.azm(pos)
    a = cf.amplitudes[0](pos).at[1:].mul(1.0 / azm)
    ea_folded = _mirror_unfold(a[cf.distributors[0]], tuple(pd.shape))
    np.testing.assert_array_equal(np.asarray(ea_folded), np.asarray(a)[pd])


def test_pwl_features_primitive_transforms():
    """The relu-feature primitive (knot-spectrum hot path) agrees with its
    naive jnp formula under grad / jvp / linear_transpose / vmap / jit."""
    from nifty_tpu.models.correlated_field import _pwl_relu_features

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0.0, 5.0, size=(7, 9)))
    knots = jnp.asarray(np.sort(rng.uniform(0.0, 5.0, size=6)))
    coef = jnp.asarray(rng.normal(size=5))

    def naive(c):
        return jnp.sum(c * jnp.maximum(x[..., None] - knots[:-1], 0.0), -1)

    f = lambda c: _pwl_relu_features(x, knots, c)
    np.testing.assert_allclose(np.asarray(f(coef)), np.asarray(naive(coef)), atol=1e-13)

    # reverse mode (the custom fused transpose)
    ct = jnp.asarray(rng.normal(size=x.shape))
    g1 = jax.grad(lambda c: jnp.vdot(f(c), ct))(coef)
    g2 = jax.grad(lambda c: jnp.vdot(naive(c), ct))(coef)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-12)

    # forward mode
    t = jnp.asarray(rng.normal(size=5))
    np.testing.assert_allclose(
        np.asarray(jax.jvp(f, (coef,), (t,))[1]),
        np.asarray(jax.jvp(naive, (coef,), (t,))[1]),
        atol=1e-12,
    )

    # linear_transpose (metric path)
    lt1 = jax.linear_transpose(f, coef)(ct)
    lt2 = jax.linear_transpose(naive, coef)(ct)
    np.testing.assert_allclose(np.asarray(lt1[0]), np.asarray(lt2[0]), atol=1e-12)

    # vmap over coef batches, and jit-of-vmap, and grad-of-vmap
    C = jnp.asarray(rng.normal(size=(3, 5)))
    np.testing.assert_allclose(
        np.asarray(jax.vmap(f)(C)), np.asarray(jax.vmap(naive)(C)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(jax.jit(jax.vmap(f))(C)),
        np.asarray(jax.vmap(naive)(C)),
        atol=1e-12,
    )
    gb1 = jax.grad(lambda c: jnp.sum(jax.vmap(f)(c) ** 2))(C)
    gb2 = jax.grad(lambda c: jnp.sum(jax.vmap(naive)(c) ** 2))(C)
    np.testing.assert_allclose(np.asarray(gb1), np.asarray(gb2), atol=1e-11)

    # jvp w.r.t. x (used when x ever becomes traced)
    tx = jnp.asarray(rng.normal(size=x.shape))
    jx1 = jax.jvp(lambda xx: _pwl_relu_features(xx, knots, coef), (x,), (tx,))[1]
    jx2 = jax.jvp(
        lambda xx: jnp.sum(coef * jnp.maximum(xx[..., None] - knots[:-1], 0.0), -1),
        (x,),
        (tx,),
    )[1]
    np.testing.assert_allclose(np.asarray(jx1), np.asarray(jx2), atol=1e-12)


@pytest.mark.parametrize("op", ["apply", "pullback", "jvp_x"])
@pytest.mark.parametrize("chunk", [3, 8, None])
def test_pwl_features_chunked_match_numpy(monkeypatch, op, chunk):
    """Knot-chunked and unchunked relu features agree with float64 numpy
    (K=20 knots: chunk 3 leaves a ragged last chunk, None is unchunked)."""
    import nifty_tpu.models.correlated_field as cfmod

    monkeypatch.setattr(
        cfmod, "_pwl_knot_chunk", lambda k: k if chunk is None else min(k, chunk)
    )
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 6.0, size=(13, 17))
    knots = np.linspace(0.0, 6.0, 20)
    coef = rng.normal(size=19)
    feats = np.maximum(x[..., None] - knots[:-1], 0.0)
    xj, kj, cj = map(jnp.asarray, (x, knots, coef))
    f = lambda c: cfmod._pwl_relu_features(xj, kj, c)  # noqa: E731
    if op == "apply":
        got, want = f(cj), feats @ coef
    elif op == "pullback":
        ct = rng.normal(size=x.shape)
        (got,) = jax.linear_transpose(f, cj)(jnp.asarray(ct))
        want = np.einsum("ijk,ij->k", feats, ct)
    else:
        tx = rng.normal(size=x.shape)
        got = jax.jvp(
            lambda xx: cfmod._pwl_relu_features(xx, kj, cj), (xj,), (jnp.asarray(tx),)
        )[1]
        want = tx * ((x[..., None] > knots[:-1]) @ coef)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)


def test_vmodel_multifrequency_shared_spectrum():
    """dofdex-style multifrequency batching (reference
    ``nifty/cl/library/correlated_fields.py:659``): VModel over the
    excitations only gives n_freq bands with independent realizations but
    one shared learned spectrum."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations((24, 24), 1.0 / 24, (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    cf = cfm.finalize()
    nfreq = 5
    mf = nt.VModel(cf, nfreq, in_axes=["cfxi"])
    pos = mf.init(random.PRNGKey(0))
    assert pos["cfxi"].shape == (nfreq, 24, 24)
    assert pos["cfspectrum"].shape == (81, 2)  # shared
    out = mf(pos)
    assert out.shape == (nfreq, 24, 24)
    f = np.asarray(out)
    assert np.abs(f[0] - f[1]).max() > 1e-3  # independent realizations
    # a multifrequency cube renders as an RGB panel
    from nifty_tpu.plot import rgb_from_spectral_cube

    img = rgb_from_spectral_cube(np.exp(f))
    assert img.shape == (24, 24, 3)
