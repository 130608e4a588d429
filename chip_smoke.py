"""Smoke test of the main inference path on NVIDIA GPUs.

Drives the correlated field -> Poisson likelihood -> Fisher metric ->
``optimize_kl`` (geoVI) path once through the public API, at the widths the
repository supports, and compares every kernel of that path with a float64
reference computed on the host::

    python chip_smoke.py          # one GPU: device, kernels, model, inference
    python chip_smoke.py --four   # four GPUs: sample- and field-sharded VI,
                                  # pencil Hartley, each against one GPU

Phases run in order and any failure exits non-zero; nothing falls back to
the CPU.  The float64 references run in a child process restricted to the
CPU (``JAX_PLATFORMS=cpu``), so only this process uses the card.  The last
line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Times printed here are information, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances on max|got - want| / max|want| (float32 on the card)
TOL_GATHER = 0.0  # a gather moves values, it does no arithmetic
TOL_SCATTER = 1e-5  # atomics reorder the sums
TOL_HARTLEY = 1e-5
TOL_KNOTS = 1e-5
# The float32 Legendre recurrence is marginally stable near the poles, where
# rounding accumulates as ~lmax^1.5 · eps; at nside 256, lmax 512 the sound
# float32 synthesis is off by 1.44e-4 (an H100 and the CPU alike).  The
# limit sits between that and the nearest fault: the ring-DFT einsums with
# TF32-rounded operands give 3.6e-4, a dropped ℓ = lmax term 6.4e-2.
TOL_SHT = 2.5e-4
TOL_MODEL = 1e-4  # forward pass and metric apply vs float64
TOL_SQRT = 1e-5  # ||M t - L(R t)|| / ||M t||
TOL_SHARDED = 1e-4  # sharded vs one device, relative L2 of the result

# the widths the repository's benchmark supports
HARTLEY_SIZES = (1280, 4096)
EXPAND_SIZES = (1280, 4096)
KNOT_SIZE, N_KNOTS = 4096, 64
SHT_NSIDE, SHT_LMAX = 256, 512
MODEL_COMPARE = (((1280, 1280), None), ((1280, 1280), N_KNOTS))
MODEL_FINITE = (
    ((4096, 4096), N_KNOTS),
    ((4096, 4096), None),
    ((10240, 10240), N_KNOTS),
)
VI_SHAPE, VI_SAMPLES, VI_ITERATIONS = (1280, 1280), 4, 3
FOUR_SAMPLE_SHAPE, FOUR_FIELD_SHAPE, FOUR_FIELD_SAMPLES = (1280, 1280), (4096, 4096), 2

F32 = "float32"
F32_HIGHEST = "float32, einsums at Precision.HIGHEST"


class SmokeFailure(RuntimeError):
    """A phase found a wrong, non-finite or missing result."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != reference {want.shape}")
    check(np.all(np.isfinite(got)), "non-finite values")
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def compare(name: str, got, want, tol: float, precision: str = F32) -> float:
    err = rel_err(got, want)
    log(f"  {name}: max-abs err / max-abs ref = {err:.3e} (tol {tol:g}, {precision})")
    check(err <= tol, f"{name}: relative error {err:.3e} above {tol:g}")
    return err


def tree_rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over all leaves of two pytrees."""
    import jax

    la = [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(a)]
    lb = [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(b)]
    va, vb = np.concatenate(la), np.concatenate(lb)
    check(np.all(np.isfinite(va)), "non-finite values")
    return float(np.linalg.norm(va - vb) / max(np.linalg.norm(vb), 1e-300))


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# --- shared builders (the card and the float64 reference use the same code) --


def build_model(shape, n_mode_knots, data, field_mesh=None):
    """The Poisson correlated field of ``bench.py``: returns (lh, forward)."""
    from jax import numpy as jnp

    import nifty_tpu as nt

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        n_mode_knots=n_mode_knots,
    )
    fwd = nt.ChainModel(jnp.exp, cfm.finalize(field_mesh=field_mesh))
    return nt.Poissonian(data).amend(fwd), fwd


def model_inputs(shape, n_mode_knots, seed):
    """Seeded float32 position, tangent and int32 counts, made on the host."""
    import jax
    from jax import random

    rng = np.random.default_rng(seed)
    data = rng.poisson(1.0, size=shape).astype(np.int32)
    _, fwd = build_model(shape, n_mode_knots, data)
    shapes = jax.eval_shape(fwd.init, random.PRNGKey(0))
    draw = lambda: {  # noqa: E731
        k: rng.standard_normal(shapes[k].shape).astype(np.float32)
        for k in sorted(shapes)
    }
    pos = draw()
    return data, pos, draw()


def sht_input(lmax, seed):
    return np.random.default_rng(seed).standard_normal((lmax + 1) ** 2).astype(
        np.float32
    )


def host_reference(spec) -> dict:
    """float64 references on the CPU backend for everything in ``spec``."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import nifty_tpu as nt
    from nifty_tpu.ops.sht import healpix_synthesis

    out = {}
    if "sht" in spec:
        s = spec["sht"]
        alm = sht_input(s["lmax"], s["seed"]).astype(np.float64)
        syn = jax.jit(
            lambda a: healpix_synthesis(a, s["nside"], lmax=s["lmax"], mmax=s["lmax"])
        )
        out["sht"] = np.asarray(syn(alm))
    for m in spec.get("models", ()):
        shape, knots, seed = tuple(m["shape"]), m["knots"], m["seed"]
        data, pos, tan = model_inputs(shape, knots, seed)
        lh, fwd = build_model(shape, knots, data)
        f64 = lambda t: nt.Vector({k: v.astype(np.float64) for k, v in t.items()})  # noqa: E731
        tag = model_tag(shape, knots)
        out[f"{tag}.forward"] = np.asarray(jax.jit(fwd)(f64(pos).tree))
        met = jax.jit(lambda l, p, t: l.metric(p, t))(lh, f64(pos), f64(tan))
        for k, v in met.tree.items():
            out[f"{tag}.metric.{k}"] = np.asarray(v)
    return out


def model_tag(shape, knots) -> str:
    return f"{shape[0]}x{shape[1]}_" + ("exact" if knots is None else f"knots{knots}")


class HostReference:
    """Computes :func:`host_reference` in a child process on the CPU.

    The child never opens the card (``JAX_PLATFORMS=cpu`` and no visible
    CUDA device), so it runs beside the GPU phases."""

    def __init__(self, spec):
        self._dir = tempfile.mkdtemp(prefix="nifty_smoke_ref_")
        spec_fn = os.path.join(self._dir, "spec.json")
        self._out = os.path.join(self._dir, "ref.npz")
        self._log = os.path.join(self._dir, "child.log")
        with open(spec_fn, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        code = (
            "import sys, numpy as np, chip_smoke as s;"
            "np.savez(sys.argv[2], **s.host_reference(s.json.load(open(sys.argv[1]))))"
        )
        with open(self._log, "w") as logf:
            self._proc = subprocess.Popen(
                [sys.executable, "-c", code, spec_fn, self._out],
                cwd=REPO,
                env=env,
                stdout=logf,
                stderr=subprocess.STDOUT,
            )
        self._result = None

    def result(self, timeout: float = 900.0) -> dict:
        if self._result is None:
            rc = self._proc.wait(timeout=timeout)
            if rc != 0:
                with open(self._log) as f:
                    raise SmokeFailure(f"host reference failed (rc {rc}):\n{f.read()[-4000:]}")
            with np.load(self._out) as z:
                self._result = {k: z[k] for k in z.files}
        return self._result

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        shutil.rmtree(self._dir, ignore_errors=True)


class InProcessReference:
    """:class:`HostReference` without the child, for CPU-only runs."""

    def __init__(self, spec):
        self._result = host_reference(spec)

    def result(self, timeout: float = 0.0) -> dict:
        return self._result

    def close(self) -> None:
        pass


# --- phase 1: device -----------------------------------------------------------


def phase_device(count, cache_dir):
    import jax

    from nifty_tpu.profiling import card_line, check_device

    dev = check_device(jax.devices(), count)
    card = card_line()
    log(
        f"[device] {dev.device_kind} x{len(jax.devices())}, jax {jax.__version__},"
        f" compile cache {cache_dir}"
    )
    log(f"[device] card: {card}")
    return dev


# --- phase 2: kernels against the plain reference ------------------------------


def expand_layout(n):
    """The packed exact-spectrum layout of an n x n grid, as ``finalize``
    builds it, and the core index table it packs."""
    from nifty_tpu.models.correlated_field import get_fourier_mode_distributor
    from nifty_tpu.ops.mode_expand import build_expand_layout

    dist, um, _ = get_fourier_mode_distributor((n, n), 1.0 / n)
    core = np.ascontiguousarray(dist[: n // 2 + 1, : n // 2 + 1], dtype=np.int32)
    packed, layout = build_expand_layout(core, um.size)
    return core, packed, layout


def knot_inputs(n, n_knots, seed):
    """Relative log-|k| of the non-redundant core of an n x n grid (what the
    model evaluates the knot features on), the knots and random weights."""
    from nifty_tpu.models.correlated_field import _max_rel_log_k, _rel_log_k_grid

    x, _ = _rel_log_k_grid((n, n), (1.0 / n, 1.0 / n), core=True)
    x = np.asarray(x, np.float32)
    knots = np.linspace(0.0, _max_rel_log_k((n, n), (1.0 / n, 1.0 / n)), n_knots)
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal(n_knots - 1).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return x, knots.astype(np.float32), coef, cot


def knot_reference(x, knots, coef, cot):
    """float64 numpy: the feature sum and its pull-back w.r.t. ``coef``."""
    x = x.astype(np.float64)
    cot = cot.astype(np.float64)
    fwd = np.zeros_like(x)
    grad = np.empty(len(knots) - 1)
    for k, t in enumerate(knots[:-1].astype(np.float64)):
        feat = np.maximum(x - t, 0.0)
        fwd += float(coef[k]) * feat
        grad[k] = np.sum(cot * feat)
    return fwd, grad


def phase_kernels(hartley_sizes, expand_sizes, knot_size, n_knots, sht, reference):
    import jax
    from jax import numpy as jnp

    from nifty_tpu.models.correlated_field import _pwl_relu_features
    from nifty_tpu.ops.fft import hartley
    from nifty_tpu.ops.mode_expand import mode_expand
    from nifty_tpu.ops.sht import healpix_synthesis
    from nifty_tpu.profiling import median_seconds

    rng = np.random.default_rng(0)
    f_h = jax.jit(hartley)
    for n in hartley_sizes:
        x = rng.standard_normal((n, n)).astype(np.float32)
        ft = np.fft.fftn(x.astype(np.float64))
        xd = jnp.asarray(x)
        compare(f"hartley {n}^2", f_h(xd), ft.real - ft.imag, TOL_HARTLEY)
        log(f"    {median_seconds(f_h, xd) * 1e3:.4f} ms per call")

    for n in expand_sizes:
        core, packed, layout = expand_layout(n)
        U = layout.n_unique
        n_packed = int(np.prod(layout.packed_shape))
        log(f"  mode_expand {n}^2-exact: {layout.kind}, {n_packed} packed, {U} unique")
        tab = rng.standard_normal(U).astype(np.float32)
        cot = rng.standard_normal(core.shape).astype(np.float32)
        tab_d, cot_d = jnp.asarray(tab), jnp.asarray(cot)
        fwd = jax.jit(lambda t, i: mode_expand(t, i, layout))
        adj = jax.jit(
            lambda c, i: jax.linear_transpose(lambda t: mode_expand(t, i, layout), tab_d)(c)[0]
        )
        compare(f"gather {n}^2-exact", fwd(tab_d, packed), tab[core], TOL_GATHER)
        log(f"    {median_seconds(fwd, tab_d, packed) * 1e6:.1f} us per call")
        want = np.bincount(core.ravel(), cot.astype(np.float64).ravel(), minlength=U)
        compare(f"scatter-add {n}^2-exact", adj(cot_d, packed), want, TOL_SCATTER)
        log(f"    {median_seconds(adj, cot_d, packed) * 1e6:.1f} us per call")

    x, knots, coef, cot = knot_inputs(knot_size, n_knots, seed=1)
    want_fwd, want_grad = knot_reference(x, knots, coef, cot)
    xd, kd, cd, cotd = map(jnp.asarray, (x, knots, coef, cot))
    f_apply = jax.jit(_pwl_relu_features)
    f_pull = jax.jit(
        lambda x_, k_, c_: jax.linear_transpose(
            lambda w: _pwl_relu_features(x_, k_, w), cd
        )(c_)[0]
    )
    tag = f"{knot_size}^2 (core {x.shape[0]}^2), K={n_knots}"
    compare(f"knot features {tag}", f_apply(xd, kd, cd), want_fwd, TOL_KNOTS)
    log(f"    {median_seconds(f_apply, xd, kd, cd) * 1e3:.4f} ms per call")
    compare(f"knot pull-back {tag}", f_pull(xd, kd, cotd), want_grad, TOL_KNOTS)
    log(f"    {median_seconds(f_pull, xd, kd, cotd) * 1e3:.4f} ms per call")

    nside, lmax = sht["nside"], sht["lmax"]
    alm = jnp.asarray(sht_input(lmax, sht["seed"]))
    syn = jax.jit(lambda a: healpix_synthesis(a, nside, lmax=lmax, mmax=lmax))
    got = syn(alm)
    jax.block_until_ready(got)
    compare(
        f"healpix_synthesis nside {nside} lmax {lmax}",
        got,
        reference.result()["sht"],
        TOL_SHT,
        F32_HIGHEST,
    )
    log(f"    {median_seconds(syn, alm) * 1e3:.4f} ms per call")


# --- phase 3: the model at full width -------------------------------------------


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis unavailable"
    return (
        f"args {ma.argument_size_in_bytes / 1e9:.3f} GB, out"
        f" {ma.output_size_in_bytes / 1e9:.3f} GB, temp"
        f" {ma.temp_size_in_bytes / 1e9:.3f} GB, code"
        f" {ma.generated_code_size_in_bytes / 1e6:.1f} MB"
    )


def _metric_report(tag, lh, pos, tan, device):
    """Compile, run and time one metric apply; return it."""
    import jax

    from nifty_tpu.profiling import median_seconds

    t0 = time.perf_counter()
    compiled = jax.jit(lambda l, p, t: l.metric(p, t)).lower(lh, pos, tan).compile()
    t_compile = time.perf_counter() - t0
    out = compiled(lh, pos, tan)
    for leaf in jax.tree_util.tree_leaves(out):
        check(bool(np.all(np.isfinite(np.asarray(leaf)))), f"{tag}: non-finite metric")
    t = median_seconds(compiled, lh, pos, tan)
    log(
        f"  metric {tag}: finite; {t * 1e3:.3f} ms median apply, compile"
        f" {t_compile:.1f} s; {_memory_line(compiled)}; peak_bytes_in_use"
        f" {peak_bytes(device) / 1e9:.3f} GB"
    )
    return out


def phase_model(compare_sizes, finite_sizes, reference, seed=3):
    import jax
    from jax import numpy as jnp
    from jax import random

    import nifty_tpu as nt

    device = jax.devices()[0]
    for shape, knots in compare_sizes:
        tag = model_tag(shape, knots)
        data, pos_np, tan_np = model_inputs(shape, knots, seed)
        lh, fwd = build_model(shape, knots, jnp.asarray(data))
        pos = nt.Vector({k: jnp.asarray(v) for k, v in pos_np.items()})
        tan = nt.Vector({k: jnp.asarray(v) for k, v in tan_np.items()})
        ref = reference.result()
        compare(f"forward {tag}", jax.jit(fwd)(pos.tree), ref[f"{tag}.forward"], TOL_MODEL)
        met = _metric_report(tag, lh, pos, tan, device)
        keys = sorted(met.tree)
        compare(
            f"metric {tag}",
            np.concatenate([np.asarray(met.tree[k]).ravel() for k in keys]),
            np.concatenate([ref[f"{tag}.metric.{k}"].ravel() for k in keys]),
            TOL_MODEL,
        )
        lr = jax.jit(lambda l, p, t: l.left_sqrt_metric(p, l.right_sqrt_metric(p, t)))
        gap = tree_rel_l2(lr(lh, pos, tan), met)
        log(f"  metric - L(R(.)) {tag}: relative L2 gap {gap:.3e} (tol {TOL_SQRT:.0e}, {F32})")
        check(gap <= TOL_SQRT, f"{tag}: metric != left_sqrt o right_sqrt ({gap:.3e})")
        del lh, fwd, pos, tan, met

    for shape, knots in finite_sizes:
        tag = model_tag(shape, knots)
        t0 = time.perf_counter()
        key = random.PRNGKey(seed)
        data = random.poisson(key, 1.0, shape).astype(jnp.int32)
        lh, fwd = build_model(shape, knots, data)
        shapes = jax.eval_shape(fwd.init, random.PRNGKey(0))
        keys = iter(random.split(key, 2 * len(shapes)))
        pos, tan = (
            nt.Vector({k: random.normal(next(keys), v.shape, v.dtype) for k, v in shapes.items()})
            for _ in range(2)
        )
        log(f"  {tag}: built in {time.perf_counter() - t0:.1f} s")
        _metric_report(tag, lh, pos, tan, device)
        del lh, fwd, pos, tan, data


# --- phase 4: inference -----------------------------------------------------------


def vi_problem(shape, knots, seed, field_mesh=None):
    """Synthetic counts drawn from the prior, a start near the origin, and
    the forward model (finalized on ``field_mesh`` when given)."""
    import jax
    from jax import numpy as jnp
    from jax import random

    _, fwd = build_model(shape, knots, np.zeros(shape, np.int32))
    k_truth, k_start = random.split(random.PRNGKey(seed))
    rate = np.asarray(jax.jit(lambda k: fwd(fwd.init(k)))(k_truth))
    data = np.random.default_rng(seed).poisson(np.clip(rate, 0, 1e6)).astype(np.int32)
    lh, fwd = build_model(shape, knots, jnp.asarray(data), field_mesh)
    pos = jax.tree_util.tree_map(lambda x: 0.1 * x, fwd.init(k_start))
    return lh, pos, fwd


VI_KWARGS = dict(
    draw_linear_kwargs=dict(cg_name=None, cg_kwargs=dict(absdelta=1e-4, maxiter=40)),
    nonlinearly_update_kwargs=dict(
        minimize_kwargs=dict(name=None, xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=20))
    ),
    kl_kwargs=dict(
        minimize_kwargs=dict(name=None, xtol=1e-4, maxiter=2, cg_kwargs=dict(maxiter=40))
    ),
    sample_mode="nonlinear_resample",
)


# Short fixed solver budgets for the sharded-vs-one-device comparisons: no
# stopping rule reads a value whose last bits depend on the order of a sum,
# and five CG steps keep the Krylov recurrence from amplifying those bits
# (on four virtual CPU devices in float32 the posterior means agree to ~1e-6
# after 5 CG steps but only to ~1e-3 after 10).
_FIXED_CG = dict(resnorm=-1.0, miniter=5, maxiter=5)
_FIXED_NEWTON = dict(
    name=None, xtol=-1.0, maxiter=1, energy_reduction_factor=0.0, cg_kwargs=_FIXED_CG
)
VI_KWARGS_FIXED = dict(
    draw_linear_kwargs=dict(cg_name=None, cg_kwargs=_FIXED_CG),
    nonlinearly_update_kwargs=dict(minimize_kwargs=_FIXED_NEWTON),
    kl_kwargs=dict(minimize_kwargs=_FIXED_NEWTON),
    sample_mode="nonlinear_resample",
)


def run_vi(lh, pos, *, n_samples, n_iterations, seed, **kwargs):
    """``optimize_kl`` with per-iteration energies and wall times."""
    import jax
    from jax import random

    import nifty_tpu as nt

    energies, stamps = [], [time.perf_counter()]

    def callback(samples, state):
        jax.block_until_ready(samples)
        energies.append(float(state.minimization_state.fun))
        stamps.append(time.perf_counter())

    samples, _ = nt.optimize_kl(
        lh,
        pos,
        key=random.PRNGKey(seed),
        n_total_iterations=n_iterations,
        n_samples=n_samples,
        callback=callback,
        odir=None,
        **{**VI_KWARGS, **kwargs},
    )
    return samples, energies, np.diff(stamps)


def phase_inference(shape, knots, n_samples, n_iterations, seed=5):
    lh, pos, _ = vi_problem(shape, knots, seed)
    _, energies, secs = run_vi(
        lh, pos, n_samples=n_samples, n_iterations=n_iterations, seed=seed + 1
    )
    tag = model_tag(shape, knots)
    log(f"  geoVI {tag}, {n_samples} samples: energies {[f'{e:.6e}' for e in energies]}")
    check(len(energies) == n_iterations, f"{len(energies)} of {n_iterations} iterations ran")
    check(all(np.isfinite(energies)), "non-finite KL energy")
    check(energies[-1] < energies[0], "KL energy did not fall")
    steady = f"{np.mean(secs[1:]):.3f}" if len(secs) > 1 else "n/a"
    log(f"  first (compiling) iteration {secs[0]:.2f} s, then {steady} s per iteration")
    return energies


# --- four devices --------------------------------------------------------------------


def posterior_mean(samples):
    import jax

    return jax.tree_util.tree_map(lambda s: np.asarray(s).mean(axis=0), samples.samples)


def four_sample_sharded(devices, shape, knots, n_samples, seed=7):
    """Sample-sharded ``optimize_kl`` against the same keys on one device."""
    lh, pos, _ = vi_problem(shape, knots, seed)
    kw = dict(n_samples=n_samples, n_iterations=1, seed=seed + 1, **VI_KWARGS_FIXED)
    s_one, e_one, t_one = run_vi(lh, pos, **kw)
    s_all, e_all, t_all = run_vi(lh, pos, devices=list(devices), **kw)
    err = tree_rel_l2(posterior_mean(s_all), posterior_mean(s_one))
    log(
        f"  sample-sharded geoVI {model_tag(shape, knots)} over {len(devices)}"
        f" devices: posterior-mean rel L2 diff {err:.3e} (tol {TOL_SHARDED:.0e}),"
        f" energy {e_all[0]:.6e} vs {e_one[0]:.6e}; {t_all[0]:.1f} s sharded,"
        f" {t_one[0]:.1f} s on one device (with compile)"
    )
    check(err <= TOL_SHARDED, f"sample-sharded posterior mean differs ({err:.3e})")


def four_field_sharded(devices, shape, knots, n_samples, seed=9):
    """Field-sharded ``optimize_kl`` on a flat ``fx`` mesh against the same
    keys on one device."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(devices), ("fx",))
    kw = dict(n_samples=n_samples, n_iterations=1, seed=seed + 1, **VI_KWARGS_FIXED)
    lh, pos, _ = vi_problem(shape, knots, seed)
    s_one, e_one, t_one = run_vi(lh, pos, **kw)
    lh, pos, fwd = vi_problem(shape, knots, seed, field_mesh=mesh)
    sharding = fwd.inner.position_sharding()
    s_shd, e_shd, t_shd = run_vi(lh, pos, position_sharding=sharding, **kw)
    err = tree_rel_l2(posterior_mean(s_shd), posterior_mean(s_one))
    xi = s_shd.pos["cfxi"]
    shard_shapes = sorted({tuple(s.data.shape) for s in xi.addressable_shards})
    want = (shape[0] // len(devices),) + tuple(shape[1:])
    peaks = [f"{peak_bytes(d) / 1e9:.3f}" for d in devices]
    log(
        f"  field-sharded geoVI {model_tag(shape, knots)} on fx={len(devices)}:"
        f" posterior-mean rel L2 diff {err:.3e} (tol {TOL_SHARDED:.0e}), energy"
        f" {e_shd[0]:.6e} vs {e_one[0]:.6e}; cfxi shards {shard_shapes} on"
        f" {len(xi.addressable_shards)} devices; {t_shd[0]:.1f} s sharded,"
        f" {t_one[0]:.1f} s on one device (with compile); peak_bytes_in_use"
        f" per device (GB) {peaks}"
    )
    check(err <= TOL_SHARDED, f"field-sharded posterior mean differs ({err:.3e})")
    check(
        shard_shapes == [want]
        and {s.device for s in xi.addressable_shards} == set(devices),
        f"cfxi shards {shard_shapes}, want one {want} on each of {len(devices)} devices",
    )


def four_hartley(devices, n):
    import jax
    from jax import numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from nifty_tpu.ops.fft import hartley
    from nifty_tpu.parallel.fft import sharded_hartley2

    mesh = Mesh(np.asarray(devices), ("fx",))
    x = np.random.default_rng(11).standard_normal((n, n)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec("fx", None)))
    got = jax.jit(lambda a: sharded_hartley2(a, mesh))(xs)
    want = jax.jit(hartley)(jax.device_put(jnp.asarray(x), devices[0]))
    compare(f"sharded_hartley2 {n}^2 on fx={len(devices)} vs hartley", got, want, TOL_HARTLEY)


# --- driver ---------------------------------------------------------------------------


def _import_repo():
    """Import the package that sits beside this script, and nothing else."""
    sys.path.insert(0, REPO)
    try:
        import nifty_tpu
    except ImportError as e:
        raise SmokeFailure(f"run from a checkout of the repository ({e})") from e
    where = os.path.dirname(os.path.dirname(os.path.abspath(nifty_tpu.__file__)))
    check(where == REPO, f"nifty_tpu imported from {where}, not from {REPO}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four",
        action="store_true",
        help="run only the four-GPU phases (sharded VI and Hartley vs one GPU)",
    )
    args = parser.parse_args(argv)
    _import_repo()
    from nifty_tpu.profiling import enable_compile_cache

    cache_dir = enable_compile_cache()
    import jax

    t_start = time.perf_counter()
    count = 4 if args.four else 1
    dev = phase_device(count, cache_dir)
    devices = jax.devices()[:count]
    if args.four:
        for name, phase in (
            ("sample-sharded geoVI", lambda: four_sample_sharded(
                devices, FOUR_SAMPLE_SHAPE, None, VI_SAMPLES)),
            ("field-sharded geoVI", lambda: four_field_sharded(
                devices, FOUR_FIELD_SHAPE, N_KNOTS, FOUR_FIELD_SAMPLES)),
            ("pencil Hartley", lambda: four_hartley(devices, FOUR_FIELD_SHAPE[0])),
        ):
            t0 = time.perf_counter()
            log(f"[four] {name}")
            phase()
            log(f"[four] {name} done in {time.perf_counter() - t0:.1f} s")
    else:
        spec = dict(
            sht=dict(nside=SHT_NSIDE, lmax=SHT_LMAX, seed=2),
            models=[dict(shape=s, knots=k, seed=3) for s, k in MODEL_COMPARE],
        )
        reference = HostReference(spec)
        try:
            t0 = time.perf_counter()
            log("[kernels] against float64 host references")
            phase_kernels(
                HARTLEY_SIZES,
                EXPAND_SIZES,
                KNOT_SIZE,
                N_KNOTS,
                spec["sht"],
                reference,
            )
            log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("[model] Poisson correlated field, Fisher metric")
            phase_model(MODEL_COMPARE, MODEL_FINITE, reference)
            log(f"[model] done in {time.perf_counter() - t0:.1f} s")
        finally:
            reference.close()
        t0 = time.perf_counter()
        log("[inference] optimize_kl, geoVI")
        phase_inference(VI_SHAPE, None, VI_SAMPLES, VI_ITERATIONS)
        log(f"[inference] done in {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    result = {
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
