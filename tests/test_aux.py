"""Auxiliary subsystems: empirical PS, check_model, plot, parametric VI,
config files, consistency checks."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt


def test_empirical_power_spectrum_white_noise():
    """White noise has a flat spectrum ~ sigma^2 * dvol."""
    n = 256
    x = np.random.default_rng(0).normal(size=(n, n))
    ps, k = nt.compute_empirical_power_spectrum(x, distances=1.0 / n, n_bins=16)
    assert ps.shape[-1] == k.shape[0]
    ps = np.asarray(ps)
    # flat in the well-populated interior bins (edge bins hold few modes
    # and have large estimator variance)
    interior = ps[2:-1]
    assert interior.max() / interior.min() < 4.0


def test_empirical_power_spectrum_recovers_powerlaw():
    """A CF with known spectrum: empirical PS follows the amplitude^2."""
    shape = (128,)
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.1), (-4.0, 0.1))
    cf = cfm.finalize()
    p = cf.init(random.PRNGKey(0))
    out = cf(p)
    ps, k = nt.compute_empirical_power_spectrum(
        np.asarray(out), distances=1.0 / shape[0], n_bins=12
    )
    ps = np.asarray(ps)
    # steep red spectrum: power decreases over k by orders of magnitude
    assert ps[0] > ps[-1] * 10


def test_check_model_runs_and_reports():
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations((32,), 1.0 / 32, (1.0, 0.5), (-3.0, 0.2))
    cf = cfm.finalize()
    p = cf.init(random.PRNGKey(0))
    msgs = []
    report = nt.check_model(cf, p, log=msgs.append)
    assert set(report) == {"forward", "jvp", "vjp"}
    for mode in report.values():
        assert mode["time_jit"] > 0
    assert any("forward" in m for m in msgs)


def test_plot_panels(tmp_path):
    from nifty_tpu.plot import Plot

    rng = np.random.default_rng(0)
    p = Plot()
    p.add(rng.normal(size=100), title="line")
    p.add(rng.normal(size=(32, 32)), title="image")
    p.add(rng.normal(size=12 * 4**2), title="healpix")
    p.add((np.geomspace(1, 100, 20), np.geomspace(1, 1e-4, 20)),
          kind="loglog", title="spec")
    fn = os.path.join(tmp_path, "out.png")
    p.output(name=fn)
    assert os.path.isfile(fn) and os.path.getsize(fn) > 0


def test_mollweide_grid():
    from nifty_tpu.plot import mollweide_grid_from_healpix

    m = np.arange(12.0 * 4**2)
    g = mollweide_grid_from_healpix(m, xsize=128)
    assert g.shape == (64, 128)
    inside = np.isfinite(g)
    assert inside.any() and (~inside).any()
    assert g[inside].min() >= 0 and g[inside].max() < m.size


def _tiny_linear_lh(n_dat=8, n_par=4, noise_std=0.3, seed=0):
    a = random.normal(random.PRNGKey(seed), (n_dat, n_par)) / jnp.sqrt(n_par)
    xi = random.normal(random.PRNGKey(seed + 1), (n_par,))
    data = a @ xi + noise_std * random.normal(random.PRNGKey(seed + 2), (n_dat,))
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std**2).amend(
        lambda x: a @ x, domain=jnp.zeros((n_par,))
    )
    m = np.asarray(a.T @ a / noise_std**2 + jnp.eye(n_par))
    cov = np.linalg.inv(m)
    mean = cov @ np.asarray(a.T @ data / noise_std**2)
    return lh, mean, cov


def test_mean_field_vi():
    lh, mean, cov = _tiny_linear_lh()
    mf = nt.MeanFieldVI(lh, jnp.zeros(4), n_samples=8)
    mf.fit(random.PRNGKey(3), n_steps=600)
    np.testing.assert_allclose(np.asarray(mf.mean), mean, atol=0.1)
    np.testing.assert_allclose(
        np.asarray(mf.std), np.sqrt(np.diag(cov)), rtol=0.4
    )


def test_full_covariance_vi():
    lh, mean, cov = _tiny_linear_lh()
    fc = nt.FullCovarianceVI(lh, jnp.zeros(4), n_samples=8)
    fc.fit(random.PRNGKey(4), n_steps=800)
    np.testing.assert_allclose(np.asarray(fc.mean), mean, atol=0.1)
    np.testing.assert_allclose(np.asarray(fc.covariance()), cov, atol=0.15)


def test_consistency_checks_pass_for_valid_model():
    lh, _, _ = _tiny_linear_lh()
    pos = lh.init(random.PRNGKey(5))
    nt.extra.check_likelihood_metrics(lh, pos, random.PRNGKey(6))
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations((16,), 1.0 / 16, (1.0, 0.5), (-3.0, 0.2))
    cf = cfm.finalize()
    p = cf.init(random.PRNGKey(7))
    nt.extra.check_model_jacobian(cf, p, random.PRNGKey(8))


def test_check_linear_model():
    a = random.normal(random.PRNGKey(9), (6, 6))
    nt.extra.check_linear_model(
        lambda x: a @ x, jnp.zeros(6), random.PRNGKey(10)
    )


CFG = """
[optimization]
output directory = {odir}

[base.opt]
sample mode = linear_resample

[optimization.1]
base = base.opt
total iterations = 3
n samples = 2*2,3

[optimization.02]
base = base.opt
total iterations = 2
n samples = 4
sample mode = nonlinear_update
"""


def test_optimize_kl_config_parsing(tmp_path):
    from configparser import ConfigParser

    from nifty_tpu.config_file import OptimizeKLConfig

    cfg_file = os.path.join(tmp_path, "c.cfg")
    with open(cfg_file, "w") as f:
        f.write(CFG.format(odir=os.path.join(tmp_path, "out")))
    cfg = OptimizeKLConfig.from_file(cfg_file)
    d = dict(cfg)
    assert d["n_total_iterations"] == 5
    ns = d["n_samples"]
    assert [ns(i) for i in range(5)] == [2, 2, 3, 4, 4]
    sm = d["sample_mode"]
    assert sm(0) == "linear_resample" and sm(4) == "nonlinear_update"


def test_optimize_kl_config_run(tmp_path):
    """Full config-driven inference on a tiny model."""
    from configparser import ConfigParser

    from nifty_tpu.config_file import OptimizeKLConfig

    cfg_file = os.path.join(tmp_path, "c.cfg")
    with open(cfg_file, "w") as f:
        f.write(
            "[optimization]\n"
            f"output directory = {os.path.join(tmp_path, 'out')}\n"
            "[optimization.0]\n"
            "total iterations = 2\n"
            "n samples = 2\n"
            "sample mode = linear_resample\n"
            "likelihood = *lh\n"
        )

    def build_lh():
        lh, _, _ = _tiny_linear_lh()
        return lh

    cfg = OptimizeKLConfig.from_file(cfg_file, {"lh": lambda: build_lh()})
    samples, state = cfg.optimize_kl(
        build_lh().init(random.PRNGKey(11)), key=random.PRNGKey(12)
    )
    assert state.nit == 2
    assert len(samples) == 4  # 2 mirrored samples


def test_new_prior_families_match_scipy():
    from scipy.stats import beta as beta_d
    from scipy.stats import gamma as gamma_d
    from scipy.stats import invgamma, kstest

    x = np.asarray(random.normal(random.PRNGKey(13), (20000,)))
    s = np.asarray(nt.GammaPrior(2.0, 3.0, name="g")({"g": jnp.asarray(x)}))
    assert kstest(s, gamma_d(a=2.0, scale=3.0).cdf).pvalue > 1e-3
    s = np.asarray(nt.BetaPrior(2.0, 5.0, name="b")({"b": jnp.asarray(x)}))
    assert kstest(s, beta_d(a=2.0, b=5.0).cdf).pvalue > 1e-3
    assert s.min() > 0 and s.max() < 1
    s = np.asarray(
        nt.LogInvGammaPrior(3.0, 2.0, name="l")({"l": jnp.asarray(x)})
    )
    assert kstest(np.exp(s), invgamma(a=3.0, scale=2.0).cdf).pvalue > 1e-3


def test_samples_persistence_roundtrip(tmp_path):
    from nifty_tpu.io import load_samples, samples_to_hdf5, save_samples

    smpls = nt.Samples(
        pos={"a": jnp.ones(4)},
        samples={"a": jnp.asarray(np.random.default_rng(0).normal(size=(3, 4)))},
    )
    fn = os.path.join(tmp_path, "s.pkl")
    save_samples(smpls, fn)
    back = load_samples(fn)
    np.testing.assert_allclose(
        np.asarray(back.samples["a"]), np.asarray(smpls.samples["a"])
    )
    h5 = os.path.join(tmp_path, "s.h5")
    samples_to_hdf5(smpls, h5, operators={"sq": lambda s: {"a": s["a"] ** 2}})
    import h5py

    with h5py.File(h5) as f:
        assert f.attrs["n_samples"] == 3
        assert f["latent"]["samples"]["0"].shape == (3, 4)
        assert f["sq"]["mean"]["0"].shape == (4,)


def test_vmodel_multifrequency_cf():
    """Batched (multi-frequency) correlated fields via VModel — the
    jax-native counterpart of the cl CFM's total_N/dofdex batching
    (reference: nifty/cl/library/correlated_fields.py:659)."""
    cfm = nt.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations((32,), 1.0 / 32, (1.0, 0.5), (-3.0, 0.2))
    cf = cfm.finalize()
    vcf = nt.VModel(cf, axis_size=3)
    p = vcf.init(random.PRNGKey(14))
    out = vcf(p)
    assert out.shape == (3, 32)
    # frequencies are independent: different realizations per slice
    assert float(np.abs(np.asarray(out[0] - out[1])).max()) > 1e-3
    # gradient flows through the batch
    g = jax.grad(lambda q: float(0) + jnp.sum(vcf(q) ** 2))(p)
    assert all(
        np.all(np.isfinite(np.asarray(l))) for l in jax.tree_util.tree_leaves(g)
    )


def test_probing_module():
    from nifty_tpu.probing import StatCalculator, probe_diagonal

    a = random.normal(random.PRNGKey(15), (12, 12))
    m = np.asarray(a @ a.T)
    diag = probe_diagonal(lambda x: jnp.asarray(m) @ x, jnp.zeros(12))
    np.testing.assert_allclose(np.asarray(diag), np.diag(m), rtol=1e-10)
    # stochastic estimate in the right ballpark
    sd = probe_diagonal(
        lambda x: jnp.asarray(m) @ x,
        jnp.zeros(12),
        random.PRNGKey(16),
        n_probes=300,
    )
    np.testing.assert_allclose(
        np.asarray(sd), np.diag(m), atol=3 * np.abs(m).max() / np.sqrt(300)
    )
    st = StatCalculator()
    data = np.random.default_rng(1).normal(size=(50, 4))
    for row in data:
        st.add(jnp.asarray(row))
    np.testing.assert_allclose(np.asarray(st.mean), data.mean(0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st.var), data.var(0, ddof=1), rtol=1e-5)


def test_density_estimator():
    from nifty_tpu.models.correlated_field import density_estimator

    model, pshape = density_estimator((24,), prefix="de")
    assert pshape == (48,)
    p = model.init(random.PRNGKey(17))
    out = model(p)
    assert out.shape == pshape
    assert np.all(np.asarray(out) > 0)  # a density


def test_rgb_from_spectral_cube_and_plot():
    from nifty_tpu.plot import Plot, rgb_from_spectral_cube

    rng = np.random.default_rng(0)
    cube = rng.random((9, 12, 10))
    img = rgb_from_spectral_cube(cube)
    assert img.shape == (12, 10, 3)
    assert 0.0 <= img.min() and img.max() <= 1.0
    # a flat white spectrum maps to a gray-ish pixel (all channels close)
    flat = np.ones((9, 2, 2))
    g = rgb_from_spectral_cube(flat)
    assert np.abs(g - g.mean(-1, keepdims=True)).max() < 0.25
    # a cube panel renders through Plot without error
    import tempfile, os

    p = Plot()
    p.add(cube, title="mf sky")
    with tempfile.TemporaryDirectory() as d:
        p.output(name=os.path.join(d, "mf.png"))
        assert os.path.exists(os.path.join(d, "mf.png"))


def test_unique_and_amend_unique():
    from nifty_tpu.num.unique import amend_unique, amend_unique_, unique

    rng = np.random.default_rng(0)
    base = rng.normal(size=(3, 4))
    # stack with exact and near duplicates along the last axis
    cols = [base[:, 0], base[:, 1], base[:, 0] + 1e-12, base[:, 2],
            base[:, 1] * (1 + 1e-9), base[:, 3]]
    ar = np.stack(cols, axis=-1)
    u, inv = unique(ar, return_inverse=True, axis=-1)
    assert u.shape[-1] == 4
    np.testing.assert_array_equal(inv, [0, 1, 0, 2, 1, 3])
    np.testing.assert_allclose(np.take(u, inv, axis=-1), ar, atol=1e-8)

    # amend: duplicate is absorbed, new element appended
    ar2, idx = amend_unique(u, base[:, 1], axis=-1)
    assert idx == 1 and ar2.shape == u.shape
    new = rng.normal(size=3)
    ar3, idx3 = amend_unique(u, new, axis=-1)
    assert idx3 == 4 and ar3.shape[-1] == 5

    # traced fixed-capacity variant
    import jax.numpy as jnp

    buf = jnp.full((3, 8), jnp.nan)
    buf, i0 = amend_unique_(buf, jnp.asarray(base[:, 0]), axis=-1)
    buf, i1 = amend_unique_(buf, jnp.asarray(base[:, 1]), axis=-1)
    buf, i2 = amend_unique_(buf, jnp.asarray(base[:, 0]), axis=-1)
    assert (int(i0), int(i1), int(i2)) == (0, 1, 0)
    np.testing.assert_allclose(np.asarray(buf[:, 0]), base[:, 0])


def test_profiling_sugar():
    from nifty_tpu.profiling import CountingCall, cost_analysis, exec_time

    f = lambda x: jnp.sum(jnp.exp(x) ** 2)
    x = jnp.ones((32, 32))
    t = exec_time(f, x, n=1, verbose=False)
    assert set(t) == {"compile", "forward", "jvp", "vjp"}
    assert all(v > 0 for v in t.values())

    ca = cost_analysis(f, x)
    assert ca["flops"] > 0

    inner = CountingCall(jnp.exp, name="exp")
    g = lambda x: jnp.sum(inner(x) ** 2)
    _ = jax.jit(g)(x)
    assert inner.n_apply == 1
    _ = jax.jit(jax.value_and_grad(g))(x)
    assert inner.n_jvp + inner.n_apply >= 2


def test_no_host_transfers_guard():
    from nifty_tpu.extra import check_no_host_transfers, no_host_transfers

    x = jnp.ones(4)
    f = jax.jit(lambda x: x * 2)
    f(x)  # compile outside the guard
    np.testing.assert_allclose(np.asarray(check_no_host_transfers(f, x)), 2.0)
    # an implicit device→host coercion trips the guard
    with pytest.raises(Exception):
        with no_host_transfers():
            float(f(x))  # noqa: B018 — implicit transfer


@pytest.mark.parametrize(
    "key", ["fft_impl", "expand_network", "expand_network_max", "nope"]
)
def test_config_unknown_keys_raise(key):
    from nifty_tpu import config as cfg

    with pytest.raises(KeyError):
        cfg.update(key, "auto")


def test_config_validates_values():
    from nifty_tpu import config as cfg

    with pytest.raises(ValueError):
        cfg.update("hartley_convention", "bogus")
    cfg.update("hartley_convention", "non_canonical_hartley")
    cfg.update("hartley_convention", "canonical_hartley")
    assert cfg._config["hartley_convention"] == "canonical_hartley"


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from nifty_tpu.profiling import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper
    changes nothing (checked in a fresh process, where JAX reads it)."""
    code = (
        "import jax; from nifty_tpu.profiling import enable_compile_cache;"
        "p = enable_compile_cache();"
        "print(p); print(jax.config.jax_compilation_cache_dir)"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=repo, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_adjust_variances_rebalances_xi():
    from nifty_tpu.adjust_variances import adjust_variances

    rng = np.random.default_rng(0)
    n = 64
    # amplitude model: scalar log-amplitude per position
    def amplitude(p):
        return jnp.exp(p["loga"]) * jnp.ones(n)

    # start with an overscaled xi (std 5) and tiny amplitude: the
    # adjustment should absorb the scale into `loga`
    pos = {"loga": jnp.asarray(0.0), "xi": jnp.asarray(5.0 * rng.normal(size=n))}
    phi0 = np.asarray(amplitude(pos) * pos["xi"])
    new = adjust_variances(pos, amplitude, "xi")
    phi1 = np.asarray(amplitude(new) * new["xi"])
    np.testing.assert_allclose(phi1, phi0, rtol=1e-10)
    # xi is now closer to unit variance, amplitude grew
    assert abs(float(jnp.std(new["xi"])) - 1.0) < abs(
        float(jnp.std(pos["xi"])) - 1.0
    )
    assert float(new["loga"]) > 0.5
