"""Auxiliary micro-benchmarks: SHT, ICR refinement, NUTS, VI iteration.

Complements the headline ``bench.py`` (the reference's JOSS metric-apply
benchmark) with throughput numbers for the other hot paths
(BASELINE.md targets: samples/s, KL-iterations/s).  Run manually on a GPU:

    python bench_extra.py

Each line is one JSON record {"metric", "value", "unit"}; each time is the
median of single calls, each ended by ``block_until_ready``, after a
warm-up call.
"""

import json
import time

import jax
import numpy as np
from jax import numpy as jnp
from jax import random

import nifty_tpu as nt
from nifty_tpu.profiling import median_seconds


def _emit(metric, value, unit):
    print(json.dumps({"metric": metric, "value": round(value, 4), "unit": unit}), flush=True)


def bench_sht(nside=64):
    """HEALPix synthesis (Legendre-recurrence formulation).  Also emits
    the Legendre stage's achieved useful FLOP/s — "useful" counts the 4
    MACs per (l,m,ring) triple of the two coefficient contractions only,
    not the recurrence overhead, so it is comparable across
    implementations."""
    from nifty_tpu.ops.sht import get_healpix_synthesis

    lmax = 2 * nside
    n_alm = (lmax + 1) ** 2
    syn = get_healpix_synthesis(nside=nside, axis=0, lmax=lmax, mmax=lmax)
    alm = jnp.asarray(np.random.default_rng(0).normal(size=(n_alm,)).astype(np.float32))

    t = median_seconds(jax.jit(syn), alm)
    _emit(f"sht_synthesis_nside{nside}_lmax{lmax}", t * 1e3, "ms")
    n_rings = 4 * nside - 1
    useful_flops = 4.0 * n_rings * (lmax + 1) * (lmax + 2) / 2
    _emit(f"sht_legendre_gflops_nside{nside}", useful_flops / t / 1e9, "GFLOP/s")


def bench_sph_cfm_metric(nside=256):
    """Spherical correlated field (HEALPix grid, SHT harmonic transform):
    Fisher-metric apply — the sphere through the VI hot path."""
    cfm = nt.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (nside,),
        distances=None,
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        harmonic_type="spherical",
    )
    cf = cfm.finalize()
    out = np.asarray(jax.jit(lambda k: cf(cf.init(k)))(random.PRNGKey(0)))
    data = jnp.asarray(
        out + 0.2 * np.random.default_rng(1).normal(size=out.shape)
    ).astype(out.dtype)
    lh = nt.Gaussian(data, noise_std_inv=lambda x: 5.0 * x).amend(cf)
    pos = nt.Vector(lh.init(random.PRNGKey(2)))
    metric = jax.jit(lambda l, p, t: l.metric(p, t))
    t = median_seconds(metric, lh, pos, pos)
    _emit(f"sph_cfm_metric_apply_nside{nside}", t * 1e3, "ms")


def _build_poisson_cf_lh(shape, knots):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        n_mode_knots=knots,
    )
    cf = cfm.finalize()
    fwd = nt.ChainModel(jnp.exp, cf)
    rate = np.asarray(jax.jit(lambda k: fwd(fwd.init(k)))(random.PRNGKey(0)))
    data = np.random.default_rng(1).poisson(np.clip(rate, 0, 1e6)).astype(np.int32)
    return nt.Poissonian(data).amend(fwd)


def bench_geovi_iteration(shape=(1024, 1024), knots=64, n_samples=2):
    """One full geoVI iteration — mirrored linear draw, per-sample
    nonlinear (geometric) residual update, one Newton-CG KL step — as a
    single jitted program.  Emits s/iteration and posterior samples/s
    (BASELINE.md north-star metrics), knot and exact spectra."""
    from functools import partial

    from nifty_tpu.evi import nonlinearly_update_residual
    from nifty_tpu.optimize_kl import _kl_met, _kl_vg

    lh = _build_poisson_cf_lh(shape, knots)
    pos = nt.Vector(lh.init(random.PRNGKey(2)))
    keys = random.split(random.PRNGKey(3), n_samples)

    def step(pos):
        draw = partial(
            nt.draw_linear_residual,
            lh,
            cg=nt.static_cg,
            cg_kwargs=dict(maxiter=20, miniter=20, resnorm=-1.0),
        )
        smpls, _ = jax.vmap(draw, in_axes=(None, 0))(pos, keys)
        smpls = jax.tree_util.tree_map(
            lambda s: jnp.concatenate([s, -s], axis=0), smpls
        )
        signs = jnp.concatenate([jnp.ones(n_samples), -jnp.ones(n_samples)])
        keys2 = jnp.concatenate([keys, keys])
        upd = partial(
            nonlinearly_update_residual,
            lh,
            pos,
            minimize_kwargs=dict(
                maxiter=2,
                xtol=-1.0,
                cg_kwargs=dict(maxiter=5, miniter=5, resnorm=-1.0),
            ),
        )
        smpls, _ = jax.vmap(upd, in_axes=(0, 0, 0))(smpls, keys2, signs)
        samples = nt.Samples(pos=pos, samples=smpls, keys=keys)
        res = nt.static_newton_cg(
            x0=pos,
            fun_and_grad=partial(_kl_vg, lh, primals_samples=samples),
            hessp=partial(_kl_met, lh, primals_samples=samples),
            maxiter=1,
            cg_kwargs=dict(maxiter=10, miniter=10, resnorm=-1.0),
        )
        return res.x

    t = median_seconds(jax.jit(step), pos, n=3)
    tag = f"knots{knots}" if knots else "exact"
    _emit(f"geovi_iteration_{shape[0]}x{shape[1]}_{tag}_{n_samples}smpl", t, "s")
    _emit(
        f"geovi_samples_per_s_{shape[0]}x{shape[1]}_{tag}",
        2 * n_samples / t,
        "samples/s",
    )


def bench_vi_iteration(shape=(1024, 1024), knots=64, n_samples=2):
    """One full MGVI iteration (mirrored sample draw via static CG with a
    fixed iteration count + one Newton-CG KL step), as a single jitted
    program — seconds per KL iteration."""
    from functools import partial

    from nifty_tpu.optimize_kl import _kl_met, _kl_vg

    lh = _build_poisson_cf_lh(shape, knots)
    pos = nt.Vector(lh.init(random.PRNGKey(2)))
    keys = random.split(random.PRNGKey(3), n_samples)

    def step(pos):
        draw = partial(
            nt.draw_linear_residual,
            lh,
            cg=nt.static_cg,
            cg_kwargs=dict(maxiter=20, miniter=20, resnorm=-1.0),
        )
        smpls, _ = jax.vmap(draw, in_axes=(None, 0))(pos, keys)
        smpls = jax.tree_util.tree_map(
            lambda s: jnp.concatenate([s, -s], axis=0), smpls
        )
        samples = nt.Samples(pos=pos, samples=smpls, keys=keys)
        res = nt.static_newton_cg(
            x0=pos,
            fun_and_grad=partial(_kl_vg, lh, primals_samples=samples),
            hessp=partial(_kl_met, lh, primals_samples=samples),
            maxiter=1,
            cg_kwargs=dict(maxiter=10, miniter=10, resnorm=-1.0),
        )
        return res.x

    t = median_seconds(jax.jit(step), pos, n=3)
    tag = f"knots{knots}" if knots else "exact"
    _emit(
        f"vi_iteration_{shape[0]}x{shape[1]}_{tag}_{n_samples}smpl",
        t,
        "s",
    )
    _emit(
        f"vi_posterior_samples_per_s_{shape[0]}x{shape[1]}_{tag}",
        2 * n_samples / t,
        "samples/s",
    )


def bench_nuts(ndim=(64, 64), n_samples=64):
    """NUTS samples/s on a correlated-field posterior (single chain)."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        ndim, distances=1.0 / ndim[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=None, n_mode_knots=16,
    )
    cf = cfm.finalize()
    truth = np.asarray(jax.jit(lambda k: cf(cf.init(k)))(random.PRNGKey(4)))
    data = jnp.asarray(truth + 0.3 * np.random.default_rng(5).normal(size=ndim))
    lh = nt.Gaussian(data, noise_std_inv=lambda x: (1 / 0.3) * x).amend(cf)
    ham = nt.StandardHamiltonian(lh)

    pos = nt.Vector(lh.init(random.PRNGKey(6)))
    from nifty_tpu.hmc_oo import NUTSChain

    chain = NUTSChain(
        potential_energy=ham,
        inverse_mass_matrix=1.0,
        position_proto=pos,
        step_size=0.05,
        max_tree_depth=8,
    )
    run = jax.jit(
        lambda k, p: chain.generate_n_samples(
            k, p, num_samples=n_samples, save_intermediates=False
        )
    )
    chain_out, _ = run(random.PRNGKey(7), pos)
    jax.block_until_ready(jax.tree_util.tree_leaves(chain_out)[0])
    t0 = time.perf_counter()
    chain_out, _ = run(random.PRNGKey(8), pos)
    jax.block_until_ready(jax.tree_util.tree_leaves(chain_out)[0])
    t = time.perf_counter() - t0
    _emit(f"nuts_samples_per_s_{ndim[0]}x{ndim[1]}", n_samples / t, "samples/s")


def bench_icr(depth=6):
    """ICR refinement: coarse-to-fine GP evaluation throughput."""
    from nifty_tpu.multi_grid.correlated_field import ICRField
    from nifty_tpu.multi_grid.grid import SimpleOpenGrid

    grid = SimpleOpenGrid(shape0=(16, 16), depth=depth, padding=1)
    icr = ICRField(grid, lambda r: jnp.exp(-0.5 * (r / 0.1) ** 2))
    pos = icr.init(random.PRNGKey(9))
    t = median_seconds(jax.jit(icr), pos)
    npix_fine = np.prod(grid.shapes[-1])
    _emit(f"icr_refine_depth{depth}_{int(npix_fine)}px", t * 1e3, "ms")


def bench_sht256():
    bench_sht(nside=256)


def bench_sht512():
    bench_sht(nside=512)


def bench_geovi_1024_knot():
    bench_geovi_iteration((1024, 1024), 64)


def bench_geovi_1024_exact():
    bench_geovi_iteration((1024, 1024), None)


def bench_geovi_4096_knot():
    bench_geovi_iteration((4096, 4096), 64)


def bench_geovi_4096_exact():
    bench_geovi_iteration((4096, 4096), None)


def bench_vi_exact_1280():
    # the full exact-path VI iteration with vmapped samples: the batched
    # wide-slice gather path end-to-end ("batch rides free" check)
    bench_vi_iteration(shape=(1280, 1280), knots=None)


def main():
    from nifty_tpu.profiling import check_device, enable_compile_cache

    check_device(jax.devices())
    enable_compile_cache()
    t0 = time.time()
    budget = float(__import__("os").environ.get("NIFTY_TPU_BENCH_BUDGET", 540))
    for fn in (
        bench_sht,
        bench_vi_iteration,
        bench_nuts,
        bench_icr,
        bench_sht256,
        bench_sht512,
        bench_sph_cfm_metric,
        bench_vi_exact_1280,
        bench_geovi_1024_knot,
        bench_geovi_1024_exact,
        bench_geovi_4096_knot,
        bench_geovi_4096_exact,
    ):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            import sys
            import traceback

            print(f"bench_extra: {fn.__name__} failed: {e!r}", file=sys.stderr)
            traceback.print_exc()
        if time.time() - t0 > budget:
            break


if __name__ == "__main__":
    main()
