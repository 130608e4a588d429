"""Correlated-field GP priors with non-parametric power spectra.

The model: a standard-normal excitation field ξ in harmonic space is
colored by a learnable amplitude spectrum (power law + integrated-Wiener-
process deviations over log-|k|, or a Matérn kernel), scaled by a global
zero-mode, and mapped to position space by a harmonic transform (Hartley
on regular grids; spherical-harmonic synthesis on HEALPix grids).

All mode-binning bookkeeping (power distributors) is computed with numpy
at model-construction time — only gathers and FFTs happen on device.

Behavioral parity with ``nifty/re/correlated_field.py``; independent
implementation.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from functools import partial, reduce
from typing import Any, Callable, Optional, Tuple, Union

import jax
import numpy as np
from jax import numpy as jnp

from ..model import Model, WrappedCall
from ..num.stats_distributions import lognormal_prior, normal_prior
from ..ops.fft import hartley
from ..utils.misc import wrap
from ..utils.tree import ShapeWithDtype, random_like
from .gauss_markov import IntegratedWienerProcess

__all__ = [
    "CorrelatedFieldMaker",
    "density_estimator",
    "HEALPixGrid",
    "LMGrid",
    "MaternAmplitude",
    "NonParametricAmplitude",
    "RegularCartesianGrid",
    "RegularFourierGrid",
    "get_fourier_mode_distributor",
    "get_spherical_mode_distributor",
    "make_grid",
]


# --- mode distributors -------------------------------------------------------


def _unique_mode_distributor(m_length, uniqueness_rtol=1e-12):
    """Bin harmonic modes by (tolerantly) unique |k|.

    Returns the per-mode bin index, the unique lengths, and each bin's
    multiplicity.
    """
    um = np.unique(m_length)
    tol = uniqueness_rtol * um[-1]
    um = um[np.diff(np.append(um, 2 * um[-1])) > tol]
    binbounds = 0.5 * (um[:-1] + um[1:])
    m_length_idx = np.searchsorted(binbounds, m_length)
    m_count = np.bincount(m_length_idx.ravel(), minlength=um.size)
    if np.any(m_count == 0) or um.shape != m_count.shape:
        raise RuntimeError("invalid harmonic mode(s) encountered")
    return m_length_idx, um, m_count


def get_fourier_mode_distributor(shape, distances, uniqueness_rtol=1e-12):
    """|k|-binning for the Fourier modes of a regular grid
    (reference: ``nifty/re/correlated_field.py:134``)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = np.broadcast_to(np.atleast_1d(distances), (len(shape),))
    dk = 1.0 / (np.array(shape) * distances)

    # |k|² accumulated dimension-by-dimension via broadcasting
    k2 = None
    for n, d in zip(shape, dk):
        ax = np.arange(n)
        ax = np.minimum(ax, n - ax) * d
        ax = ax.astype(np.float64) ** 2
        k2 = ax if k2 is None else k2[..., np.newaxis] + ax
    m_length = np.sqrt(k2) if len(shape) > 1 else np.sqrt(k2)
    return _unique_mode_distributor(m_length, uniqueness_rtol=uniqueness_rtol)


def get_spherical_mode_distributor(
    nside, lmax=None, mmax=None, uniqueness_rtol=1e-12
):
    """ℓ-binning for spherical-harmonic modes in real-alm packing
    (reference: ``nifty/re/correlated_field.py:70``)."""
    lmax = 2 * nside if lmax is None else int(lmax)
    if lmax < 0:
        raise ValueError("lmax must be >= 0")
    mmax = lmax if mmax is None else int(mmax)
    if mmax < 0 or mmax > lmax:
        raise ValueError("mmax must be in [0, lmax]")
    size = (lmax + 1) ** 2 - (lmax - mmax) * (lmax - mmax + 1)

    # mode-length array in packed real-alm ordering: all m=0 first, then for
    # each m >= 1 the (real, imag) pairs for l = m..lmax
    ldist = np.empty((size,), dtype=np.float64)
    ldist[: lmax + 1] = np.arange(lmax + 1, dtype=np.float64)
    pairs = np.repeat(np.arange(lmax + 1, dtype=np.float64), 2)
    idx = lmax + 1
    for m in range(1, mmax + 1):
        n = 2 * (lmax + 1 - m)
        ldist[idx : idx + n] = pairs[2 * m :]
        idx += n
    return (
        _unique_mode_distributor(ldist, uniqueness_rtol=uniqueness_rtol),
        (lmax, mmax, size),
    )


# --- grids -------------------------------------------------------------------

RegularCartesianGrid = namedtuple(
    "RegularCartesianGrid",
    ("shape", "total_volume", "distances", "harmonic_grid"),
    defaults=(None,),
)

RegularFourierGrid = namedtuple(
    "RegularFourierGrid",
    (
        "shape",
        "power_distributor",
        "mode_multiplicity",
        "mode_lengths",
        "relative_log_mode_lengths",
        "log_volume",
    ),
)

HEALPixGrid = namedtuple(
    "HEALPixGrid",
    ("nside", "shape", "total_volume", "harmonic_grid"),
    defaults=(None,),
)

LMGrid = namedtuple(
    "LMGrid",
    (
        "lmax",
        "mmax",
        "shape",
        "power_distributor",
        "mode_multiplicity",
        "mode_lengths",
        "relative_log_mode_lengths",
        "log_volume",
    ),
)


def _log_modes(m_length):
    """Relative log mode lengths and the log-k bin widths for the IWP."""
    um = m_length.copy()
    um[1:] = np.log(um[1:])
    um[1:] -= um[1]
    assert um[0] == 0.0
    log_vol = um[2:] - um[1:-1]
    return um, log_vol


def _rel_log_k_grid(shape, distances, core: bool = False):
    """Per-pixel relative log mode length, computed on the fly from iota.

    Returns ``(x, nonzero)`` where ``x[p] = log(|k_p| / k_min)`` for the
    non-zero modes (0 at the zero mode) and ``nonzero`` masks ``|k| > 0``.
    The convention matches the tabulated ``relative_log_mode_lengths`` of
    the exact mode distributor (the smallest non-zero mode is an axis
    fundamental, so the pixel values agree bit-for-bit in structure with
    ``_log_modes``).  Zero tables, zero gathers.  ``core=True`` restricts to the non-redundant |k|
    octant (see :func:`_k2_grid`).
    """
    k2, nonzero = _k2_grid(shape, distances, core=core)
    kmin = min(1.0 / (n * dx) for n, dx in zip(shape, distances))
    x = jnp.where(nonzero, 0.5 * jnp.log(jnp.where(nonzero, k2, 1.0)), 0.0)
    x = jnp.where(nonzero, x - np.log(kmin), 0.0)
    return x, nonzero


def _k2_grid(shape, distances, core: bool = False):
    """|k|² per harmonic-grid pixel (from iota — no tables) and a mask of
    the non-zero modes.

    With ``core=True`` only the non-redundant octant ``[0, n//2]`` per
    axis is produced — |k| on a regular Fourier grid is invariant under
    reversing any axis (``k[n-i] = -k[i]``), so every |k|-dependent
    quantity is fully determined by its values on this core and can be
    expanded with :func:`_mirror_unfold` (cheap slices/flips instead of
    per-pixel work)."""
    k2 = None
    for axis, (n, dx) in enumerate(zip(shape, distances)):
        if core:
            fold = jnp.arange(n // 2 + 1)
        else:
            idx = jnp.arange(n)
            fold = jnp.minimum(idx, n - idx)
        f = fold * (1.0 / (n * dx))
        f2 = (f * f).reshape((-1,) + (1,) * (len(shape) - axis - 1))
        k2 = f2 if k2 is None else k2 + f2
    return k2, k2 > 0


def _core_shape(shape):
    return tuple(n // 2 + 1 for n in shape)


def _core_weights(shape):
    """Mode multiplicity of each core pixel under the mirror expansion —
    broadcastable per-axis factors (1 at self-conjugate positions: the
    zero mode and, for even axes, the Nyquist mode; 2 elsewhere)."""
    factors = []
    ndim = len(shape)
    for axis, n in enumerate(shape):
        h = n // 2 + 1
        w = np.full(h, 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[h - 1] = 1.0
        factors.append(jnp.asarray(w.reshape((-1,) + (1,) * (ndim - axis - 1))))
    return factors


def _apply_core_weights(x, shape):
    for w in _core_weights(shape):
        x = x * w
    return x


def _mirror_unfold(core, full_shape):
    """Expand a core array (shape ``n//2+1`` per axis) to the full Fourier
    grid by mirroring: positions ``i >= n//2+1`` take the value at ``n-i``.
    Pure slices/flips/concats, which move each element once instead of
    gathering every pixel of the full grid from a unique-|k| table."""
    out = core
    for axis, n in enumerate(full_shape):
        if out.shape[axis] == n:
            continue
        h = n // 2 + 1
        assert out.shape[axis] == h, (out.shape, full_shape)
        mirror = jax.lax.slice_in_dim(out, 1, n - h + 1, axis=axis)
        mirror = jnp.flip(mirror, axis=axis)
        out = jnp.concatenate([out, mirror], axis=axis)
    return out


def _max_rel_log_k(shape, distances):
    """Largest relative log mode length on a regular grid (static float)."""
    kmin = min(1.0 / (n * dx) for n, dx in zip(shape, distances))
    kmax2 = sum(((n // 2) / (n * dx)) ** 2 for n, dx in zip(shape, distances))
    return 0.5 * float(np.log(kmax2)) - float(np.log(kmin))


def make_grid(shape, distances, harmonic_type, mode_tables: bool = True):
    """Build the (position, harmonic) grid pair for an amplitude model.

    With ``mode_tables=False`` (pixel-expansion amplitudes) the O(#modes)
    unique-|k| tables are not computed — at 10⁸ grid points they cost tens
    of seconds of host time and hundreds of MB that the pixel path never
    touches.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    ht = harmonic_type.lower()
    if ht == "fourier":
        distances = tuple(np.broadcast_to(distances, (len(shape),)))
        totvol = float(np.prod(np.array(shape) * np.array(distances)))
        if not mode_tables:
            harmonic_grid = RegularFourierGrid(
                shape=shape,
                power_distributor=None,
                mode_multiplicity=None,
                mode_lengths=None,
                relative_log_mode_lengths=None,
                log_volume=None,
            )
            return RegularCartesianGrid(
                shape=shape,
                total_volume=totvol,
                distances=distances,
                harmonic_grid=harmonic_grid,
            )
        m_length_idx, m_length, m_count = get_fourier_mode_distributor(
            shape, distances
        )
        um, log_vol = _log_modes(m_length)
        harmonic_grid = RegularFourierGrid(
            shape=shape,
            power_distributor=m_length_idx,
            mode_multiplicity=m_count,
            mode_lengths=m_length,
            relative_log_mode_lengths=um,
            log_volume=log_vol,
        )
        return RegularCartesianGrid(
            shape=shape,
            total_volume=totvol,
            distances=distances,
            harmonic_grid=harmonic_grid,
        )
    if ht == "spherical":
        if len(shape) != 1:
            raise ValueError("spherical `shape` is the single nside value")
        nside = shape[0]
        (m_length_idx, m_length, m_count), (lmax, mmax, size) = (
            get_spherical_mode_distributor(nside)
        )
        um, log_vol = _log_modes(m_length)
        harmonic_grid = LMGrid(
            lmax=lmax,
            mmax=mmax,
            shape=(size,),
            power_distributor=m_length_idx,
            mode_multiplicity=m_count,
            mode_lengths=m_length,
            relative_log_mode_lengths=um,
            log_volume=log_vol,
        )
        return HEALPixGrid(
            nside=nside,
            shape=(12 * nside**2,),
            total_volume=4 * np.pi,
            harmonic_grid=harmonic_grid,
        )
    raise ValueError(f"invalid harmonic_type {harmonic_type!r}")


def _remove_slope(rel_log_mode_dist, x):
    sc = rel_log_mode_dist / rel_log_mode_dist[-1]
    return x - x[-1] * sc


def _pwl_knot_chunk(n_knots: int) -> int:
    """Knot-axis chunk size for the relu-feature reductions.

    XLA:GPU fuses the (pixels, K) broadcast into the reductions of both
    the feature sum and its pull-back: on an H100 the 10240²-knot (K=64)
    metric apply needs 2.31 GB of temporaries unchunked and chunked
    alike, and the unchunked form is the faster of the two (17.5 vs
    18.7 ms device time).  XLA:CPU does *not* fuse it and materializes
    several (pixels, K) temporaries — at K=64 ~60× the field size, the
    peak-memory driver of the virtual-device ≥10⁸-dof runs (measured in
    ``probes/mem_breakdown.py``) — so on the CPU the knots are evaluated
    in chunks, bounding temporaries to (pixels, chunk)."""
    if jax.default_backend() != "cpu":
        return n_knots
    return min(n_knots, 8)


def _is_plain(x) -> bool:
    """True for values the chunked paths may slice/barrier (arrays and
    tracers).  Eager-mode transposition replays the jvp rules with new-AD
    accumulator stand-ins that support only broadcast-multiply/reduce —
    those take the dense path."""
    import jax as _jax

    return isinstance(
        x, (_jax.Array, _jax.core.Tracer, np.ndarray, float, int)
    )


def _pwl_chunk_slices(k: int, n_chunk: int):
    """Static knot-axis chunk slices (an unrolled Python loop, NOT a
    ``lax.scan``: the jvp rules run on new-AD accumulator stand-ins and
    inside linearized jaxprs whose transposition cannot interpret scan —
    elementwise/reduce ops are the only accumulator-safe vocabulary)."""
    return [slice(i, min(i + n_chunk, k)) for i in range(0, k, n_chunk)]


def _pwl_apply(res, coef):
    """Σ_k coef_k · relu(x − knot_k): fused relu-feature sum."""
    x, knots = res
    t = knots[:-1]
    n_chunk = _pwl_knot_chunk(t.shape[0])
    if n_chunk >= t.shape[0] or not all(map(_is_plain, (x, t, coef))):
        return jnp.sum(coef * jnp.maximum(x[..., None] - t, 0.0), axis=-1)
    out = None
    for s in _pwl_chunk_slices(t.shape[0], n_chunk):
        part = jnp.sum(
            coef[s] * jnp.maximum(x[..., None] - t[s], 0.0), axis=-1
        )
        out = part if out is None else out + part
        # serialize the chunks: without the barrier XLA:CPU keeps all
        # chunk temps live at once, re-creating the (pixels, K) footprint
        out, x = jax.lax.optimization_barrier((out, x))
    return out


def _pwl_transpose(res, cot):
    """Pull-back of :func:`_pwl_apply` w.r.t. `coef`: one broadcast-reduce
    over the pixel axes, knot-chunked where :func:`_pwl_knot_chunk` says
    so (the AD-derived transpose would materialize the (pixels, K)
    feature tensor)."""
    x, knots = res
    t = knots[:-1]
    n_chunk = _pwl_knot_chunk(t.shape[0])
    red_axes = tuple(range(x.ndim))
    if n_chunk >= t.shape[0] or not all(map(_is_plain, (x, t, cot))):
        feats = jnp.maximum(x[..., None] - t, 0.0)
        return jnp.sum(cot[..., None] * feats, axis=red_axes)
    grads = []
    for s in _pwl_chunk_slices(t.shape[0], n_chunk):
        feats = jnp.maximum(x[..., None] - t[s], 0.0)
        g = jnp.sum(cot[..., None] * feats, axis=red_axes)
        g, x = jax.lax.optimization_barrier((g, x))  # serialize chunks
        grads.append(g)
    return jnp.concatenate(grads)


def _pwl_jvp_x(tx, x, knots, coef):
    # d/dx Σ coef_k·relu(x − knot_k) = Σ coef_k·1(x > knot_k) (a.e.)
    t = knots[:-1]
    n_chunk = _pwl_knot_chunk(t.shape[0])
    if n_chunk >= t.shape[0] or not all(map(_is_plain, (x, t, coef))):
        steps = jnp.sum(coef * (x[..., None] > t).astype(coef.dtype), axis=-1)
        return tx * steps
    steps = None
    for s in _pwl_chunk_slices(t.shape[0], n_chunk):
        part = jnp.sum(
            coef[s] * (x[..., None] > t[s]).astype(coef.dtype), axis=-1
        )
        steps = part if steps is None else steps + part
        steps, x = jax.lax.optimization_barrier((steps, x))  # serialize
    return tx * steps


def _pwl_jvp_coef(tcoef, x, knots, coef):
    return _pwl_apply((x, knots), tcoef)


def _pwl_transpose_rule(cot, x, knots, coef):
    from jax.interpreters import ad

    if ad.is_undefined_primal(coef):
        if ad.is_undefined_primal(x) or ad.is_undefined_primal(knots):
            raise NotImplementedError(
                "pwl_features transpose only w.r.t. `coef`"
            )
        return None, None, _pwl_transpose((x, knots), cot)
    raise NotImplementedError("pwl_features is only linear in `coef`")


def _pwl_batch_rule(args, dims):
    x, knots, coef = args

    def call(x_, k_, c_):
        return _pwl_apply((x_, k_), c_)

    out = jax.vmap(call, in_axes=dims)(x, knots, coef)
    return out, 0


def _make_pwl_primitive():
    """`Σ_k coef_k·relu(x − knot_k)` as a first-class primitive.

    The pull-back w.r.t. `coef` (the metric/vjp hot path) reduces the
    pixel grid once per knot in a single fused broadcast-reduce instead of
    materializing the (n_pixels, K) feature tensor (gigabytes at ≥4096²).
    A primitive — rather than ``jax.custom_derivatives.linear_call`` —
    because it needs a *batching* rule too: under ``vmap`` (VModel-batched
    fields, vmapped VI samplers) ``linear_call`` raises at transform time,
    where no call-site fallback can catch it.
    """
    from jax.extend.core import Primitive
    from jax.interpreters import ad, batching, mlir

    prim = Primitive("nifty_pwl_features")

    def _impl(x, knots, coef):
        return _pwl_apply((x, knots), coef)

    prim.def_impl(_impl)

    def _abstract(x, knots, coef):
        dtype = jnp.result_type(x.dtype, knots.dtype, coef.dtype)
        return jax.core.ShapedArray(x.shape, dtype)

    prim.def_abstract_eval(_abstract)

    def _jvp_rule(primals, tangents):
        # The coef-linear part re-binds the primitive itself, so the
        # linear jaxpr contains `nifty_pwl_features(x, knots, tcoef)` and
        # transposition dispatches to `_pwl_transpose_rule` with a
        # concrete cotangent.  (Expressing it with raw jnp ops instead
        # makes the new-AD replay transposition re-execute the chunked
        # loop on accumulator stand-ins, which only support broadcast
        # multiply/reduce — slices and optimization_barrier assert.)
        x, knots, coef = primals
        tx, tknots, tcoef = tangents
        y = prim.bind(x, knots, coef)
        is_zero = lambda t: type(t) is ad.Zero  # noqa: E731
        if not is_zero(tknots):
            raise NotImplementedError(
                "pwl_features is not differentiable w.r.t. `knots`"
            )
        out_t = None
        if not is_zero(tx):
            out_t = _pwl_jvp_x(tx, x, knots, coef)
        if not is_zero(tcoef):
            tpart = prim.bind(x, knots, tcoef)
            out_t = tpart if out_t is None else out_t + tpart
        if out_t is None:
            out_t = ad.Zero.from_primal_value(y)
        return y, out_t

    ad.primitive_jvps[prim] = _jvp_rule
    ad.primitive_transposes[prim] = _pwl_transpose_rule
    batching.primitive_batchers[prim] = _pwl_batch_rule
    mlir.register_lowering(prim, mlir.lower_fun(_impl, multiple_results=False))
    return prim


_pwl_features_p = _make_pwl_primitive()


def _pwl_relu_features(x, knots, coef):
    """Piecewise-linear spectrum deviations on the pixel grid, linear in
    `coef`, with a custom transpose (metric/vjp hot path)."""
    dtype = jnp.result_type(x, knots, coef)
    return _pwl_features_p.bind(
        jnp.asarray(x, dtype), jnp.asarray(knots, dtype), jnp.asarray(coef, dtype)
    )


# --- amplitude models --------------------------------------------------------


class NonParametricAmplitude(Model):
    """Amplitude spectrum: power law in log|k| plus IWP deviations,
    normalized so `fluctuations` sets the total field std
    (reference: ``nifty/re/correlated_field.py:398``)."""

    fluctuations: Optional[Callable] = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    loglogavgslope: Callable = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    deviations: Optional[Callable] = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    # O(#unique modes) tables ride as dynamic pytree leaves: threaded
    # through jit as runtime parameters they never bloat the HLO with
    # giant literals
    mode_multiplicity: Any = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    relative_log_mode_lengths: Any = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    knots: Any = dataclasses.field(metadata=dict(static=False), default=None)

    def __init__(
        self,
        grid,
        fluctuations: Optional[Callable],
        loglogavgslope: Callable,
        flexibility: Optional[Callable] = None,
        asperity: Optional[Callable] = None,
        prefix: str = "",
        kind: str = "amplitude",
        n_mode_knots: Optional[int] = None,
    ):
        """With ``n_mode_knots=K`` the spectrum deviations live on K
        log-equidistant spectral knots and the amplitude is evaluated
        *per pixel* in closed form (fused relu-feature interpolation) —
        no unique-|k| tables, no per-pixel gather/scatter.
        ``None`` (default) keeps the reference's exact unique-mode tables
        (reference: ``nifty/re/correlated_field.py:398``).
        """
        self.grid = grid
        self.kind = kind.lower()
        if self.kind not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        self.pixel_mode = n_mode_knots is not None
        if self.pixel_mode:
            if not isinstance(grid, RegularCartesianGrid):
                raise TypeError(
                    "n_mode_knots requires a regular Cartesian grid"
                )
            if n_mode_knots < 2:
                raise ValueError("need at least two spectral knots")
            knots_np = np.linspace(
                0.0, _max_rel_log_k(grid.shape, grid.distances), n_mode_knots
            )
            self.knots = jnp.asarray(knots_np)
            log_vol = np.diff(knots_np)
        else:
            self.knots = None
            log_vol = grid.harmonic_grid.log_volume

        self.loglogavgslope = WrappedCall(
            loglogavgslope, name=prefix + "loglogavgslope", white_init=True
        )
        self.fluctuations = (
            WrappedCall(fluctuations, name=prefix + "fluctuations", white_init=True)
            if fluctuations is not None
            else None
        )
        if flexibility is not None and log_vol.size > 0:
            flexibility = WrappedCall(
                flexibility, name=prefix + "flexibility", white_init=True
            )
            if asperity is not None:
                asperity = WrappedCall(
                    asperity, name=prefix + "asperity", white_init=True
                )
            self.deviations = IntegratedWienerProcess(
                np.zeros((2,)),
                flexibility,
                log_vol,
                name=prefix + "spectrum",
                asperity=asperity,
            )
        else:
            self.deviations = None

        if self.pixel_mode:
            self.mode_multiplicity = None
            self.relative_log_mode_lengths = None
        else:
            self.mode_multiplicity = jnp.asarray(
                grid.harmonic_grid.mode_multiplicity
            )
            self.relative_log_mode_lengths = jnp.asarray(
                grid.harmonic_grid.relative_log_mode_lengths
            )

        models = [self.fluctuations, self.loglogavgslope, self.deviations]
        domain = reduce(
            lambda a, b: {**a, **b}, [m.domain for m in models if m is not None]
        )
        super().__init__(domain=domain, white_init=True)

    def _dev_knot_values(self, primals):
        """Deviation curve at the spectral knots, slope component removed."""
        d = self.deviations(primals)[:, 0]
        return d - d[-1] * (self.knots / self.knots[-1])

    def _ln_deviations_at(self, x, primals):
        """Piecewise-linear deviation curve evaluated at arbitrary relative
        log mode lengths `x` — a fused relu-feature sum (no gather).

        The map knot-coefficients → grid is linear; its *default* XLA
        transpose would materialize the (n_pixels, n_knots) feature tensor
        (gigabytes at ≥4096² — several hundred ms of pure HBM traffic per
        metric apply).  ``linear_call`` installs a custom pull-back that
        reduces the grid once per knot instead (sequential ``lax.map``:
        no large intermediate, ~K fused passes)."""
        d = self._dev_knot_values(primals)
        seg = jnp.diff(d) / jnp.diff(self.knots)
        coef = jnp.concatenate((seg[:1], jnp.diff(seg)))
        return _pwl_relu_features(x, self.knots, coef)

    def expanded_normalized(self, primals, azm):
        """Normalized amplitude on the full harmonic grid, evaluated per
        pixel — the gather-free equivalent of
        ``(amp(p).at[1:].mul(1/azm))[power_distributor]``."""
        return _mirror_unfold(
            self.expanded_normalized_core(primals, azm), self.grid.shape
        )

    def expanded_normalized_core(self, primals, azm):
        """Normalized per-pixel amplitude on the non-redundant |k| octant
        (``n//2+1`` per axis); expand with :func:`_mirror_unfold`.  All
        per-pixel work (relu features, exp, reductions) runs on ~1/2^d of
        the grid; the normalization sums stay exact via the mirror
        multiplicities."""
        shape = self.grid.shape
        x, nonzero = _rel_log_k_grid(shape, self.grid.distances, core=True)
        flu = 1.0 if self.fluctuations is None else self.fluctuations(primals)
        ln_spectrum = self.loglogavgslope(primals) * x
        if self.deviations is not None:
            ln_spectrum = ln_spectrum + self._ln_deviations_at(x, primals)
        spectrum = jnp.where(nonzero, jnp.exp(ln_spectrum), 0.0)
        totvol = self.grid.total_volume
        if self.kind == "amplitude":
            norm = jnp.sqrt(jnp.sum(_apply_core_weights(spectrum**2, shape)))
            amplitude = flu * (totvol / norm) * spectrum
        else:
            norm = jnp.sqrt(jnp.sum(_apply_core_weights(spectrum, shape)))
            amplitude = flu * (totvol / norm) * jnp.sqrt(spectrum)
        return jnp.where(nonzero, amplitude / azm, totvol)

    def __call__(self, primals):
        flu = 1.0 if self.fluctuations is None else self.fluctuations(primals)
        totvol = self.grid.total_volume

        if self.pixel_mode:
            # diagnostics: the normalized amplitude evaluated at the knots
            # (normalization still integrates over the full grid, computed
            # on the non-redundant |k| octant with mirror multiplicities)
            shape = self.grid.shape
            x, nonzero = _rel_log_k_grid(shape, self.grid.distances, core=True)
            ln_grid = self.loglogavgslope(primals) * x
            ln_knots = self.loglogavgslope(primals) * self.knots
            if self.deviations is not None:
                ln_grid = ln_grid + self._ln_deviations_at(x, primals)
                ln_knots = ln_knots + self._dev_knot_values(primals)
            spec_grid = jnp.where(nonzero, jnp.exp(ln_grid), 0.0)
            spectrum = jnp.exp(ln_knots)
            if self.kind == "amplitude":
                norm = jnp.sqrt(jnp.sum(_apply_core_weights(spec_grid**2, shape)))
                return flu * (totvol / norm) * spectrum
            norm = jnp.sqrt(jnp.sum(_apply_core_weights(spec_grid, shape)))
            return flu * (totvol / norm) * jnp.sqrt(spectrum)

        mode_multiplicity = self.mode_multiplicity
        rel_log_modes = self.relative_log_mode_lengths

        ln_spectrum = self.loglogavgslope(primals) * rel_log_modes
        if self.deviations is not None:
            twolog = self.deviations(primals)
            # prepend the (fixed) zero mode, keep the integrated coordinate
            twolog = jnp.concatenate((jnp.zeros((1,)), twolog[:, 0]))
            ln_spectrum = ln_spectrum + _remove_slope(rel_log_modes, twolog)
        spectrum = jnp.exp(ln_spectrum)

        # normalize out the non-zero-mode power, then scale by fluctuations
        if self.kind == "amplitude":
            norm = jnp.sqrt(jnp.sum(mode_multiplicity[1:] * spectrum[1:] ** 2))
            amplitude = flu * (totvol / norm) * spectrum
        else:
            norm = jnp.sqrt(jnp.sum(mode_multiplicity[1:] * spectrum[1:]))
            amplitude = flu * (totvol / norm) * jnp.sqrt(spectrum)
        return amplitude.at[0].set(totvol)


class MaternAmplitude(Model):
    """Matérn-kernel amplitude spectrum
    (reference: ``nifty/re/correlated_field.py:302``)."""

    scale: Optional[Callable] = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    cutoff: Callable = dataclasses.field(metadata=dict(static=False), default=None)
    loglogslope: Callable = dataclasses.field(
        metadata=dict(static=False), default=None
    )
    mode_lengths: Any = dataclasses.field(metadata=dict(static=False), default=None)
    mode_multiplicity: Any = dataclasses.field(
        metadata=dict(static=False), default=None
    )

    def __init__(
        self,
        grid,
        scale: Optional[Callable],
        cutoff: Callable,
        loglogslope: Callable,
        renormalize_amplitude: bool,
        prefix: str = "",
        kind: str = "amplitude",
        pixel_expansion: bool = False,
    ):
        """``pixel_expansion=True`` evaluates the (closed-form) Matérn
        spectrum directly per harmonic-grid pixel — no unique-|k| tables,
        no gather."""
        self.grid = grid
        self.kind = kind.lower()
        if self.kind not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        self.pixel_mode = bool(pixel_expansion)
        if self.pixel_mode and not isinstance(grid, RegularCartesianGrid):
            raise TypeError("pixel_expansion requires a regular Cartesian grid")
        self.cutoff = WrappedCall(cutoff, name=prefix + "cutoff", white_init=True)
        self.loglogslope = WrappedCall(
            loglogslope, name=prefix + "loglogslope", white_init=True
        )
        self.scale = (
            WrappedCall(scale, name=prefix + "scale", white_init=True)
            if scale is not None
            else None
        )
        self.renormalize_amplitude = renormalize_amplitude
        if self.pixel_mode:
            self.mode_lengths = None
            self.mode_multiplicity = None
        else:
            self.mode_lengths = jnp.asarray(grid.harmonic_grid.mode_lengths)
            self.mode_multiplicity = jnp.asarray(
                grid.harmonic_grid.mode_multiplicity
            )
        models = [self.scale, self.cutoff, self.loglogslope]
        domain = reduce(
            lambda a, b: {**a, **b}, [m.domain for m in models if m is not None]
        )
        super().__init__(domain=domain, white_init=True)

    def expanded_normalized(self, primals, azm):
        """Normalized Matérn amplitude on the full harmonic grid, in closed
        form per pixel (gather-free)."""
        return _mirror_unfold(
            self.expanded_normalized_core(primals, azm), self.grid.shape
        )

    def expanded_normalized_core(self, primals, azm):
        """Normalized Matérn amplitude on the non-redundant |k| octant
        (see :func:`_mirror_unfold`)."""
        shape = self.grid.shape
        k2, nonzero = _k2_grid(shape, self.grid.distances, core=True)
        scl = 1.0 if self.scale is None else self.scale(primals)
        ctf = self.cutoff(primals)
        slp = self.loglogslope(primals)
        ln_spectrum = 0.25 * slp * jnp.log1p(k2 / ctf**2)
        spectrum = jnp.where(nonzero, jnp.exp(ln_spectrum), 0.0)
        totvol = self.grid.total_volume
        norm = 1.0
        if self.renormalize_amplitude:
            if self.kind == "amplitude":
                norm = jnp.sqrt(jnp.sum(_apply_core_weights(spectrum**2, shape)))
            else:
                norm = jnp.sqrt(jnp.sum(_apply_core_weights(spectrum, shape)))
            norm = norm / jnp.sqrt(totvol)
        if self.kind == "power":
            spectrum = jnp.sqrt(spectrum)
        spectrum = scl * (jnp.sqrt(totvol) / norm) * spectrum
        return jnp.where(nonzero, spectrum / azm, totvol)

    def __call__(self, primals):
        scl = 1.0 if self.scale is None else self.scale(primals)
        ctf = self.cutoff(primals)
        slp = self.loglogslope(primals)
        if self.pixel_mode:
            # diagnostics only: spectrum at a log-spaced set of |k| values
            kmin = min(
                1.0 / (n * dx)
                for n, dx in zip(self.grid.shape, self.grid.distances)
            )
            xmax = _max_rel_log_k(self.grid.shape, self.grid.distances)
            k = kmin * jnp.exp(jnp.linspace(0.0, xmax, 64))
        else:
            k = self.mode_lengths
        ln_spectrum = 0.25 * slp * jnp.log1p((k / ctf) ** 2)
        spectrum = jnp.exp(ln_spectrum)

        totvol = self.grid.total_volume
        norm = 1.0
        if self.renormalize_amplitude:
            if self.pixel_mode:
                shape = self.grid.shape
                k2, nonzero = _k2_grid(shape, self.grid.distances, core=True)
                spec_grid = jnp.where(
                    nonzero, jnp.exp(0.25 * slp * jnp.log1p(k2 / ctf**2)), 0.0
                )
                if self.kind == "amplitude":
                    norm = jnp.sqrt(
                        jnp.sum(_apply_core_weights(spec_grid**2, shape))
                    )
                else:
                    norm = jnp.sqrt(jnp.sum(_apply_core_weights(spec_grid, shape)))
            else:
                mm = self.mode_multiplicity
                if self.kind == "amplitude":
                    norm = jnp.sqrt(jnp.sum(mm[1:] * spectrum[1:] ** 2))
                else:
                    norm = jnp.sqrt(jnp.sum(mm[1:] * spectrum[1:]))
            norm = norm / jnp.sqrt(totvol)
        if self.kind == "power":
            spectrum = jnp.sqrt(spectrum)
        spectrum = scl * (jnp.sqrt(totvol) / norm) * spectrum
        if self.pixel_mode:
            return spectrum
        return spectrum.at[0].set(totvol)


# --- the finalized model -----------------------------------------------------


class CorrelatedField(Model):
    """The finalized correlated-field model: ξ colored by the outer-product
    amplitude, mapped through the harmonic transform(s), plus the offset
    (reference assembles a closure instead,
    ``nifty/re/correlated_field.py:850-918``).

    The power-distributor index tables (full harmonic-grid shape) and the
    amplitude models' mode tables are *dynamic* pytree leaves: threaded
    through ``jit`` as arguments they stay runtime parameters.  Closure-
    captured they would be inlined into the HLO — at 10⁸ grid points that
    is a multi-hundred-MB program no compiler endpoint accepts.
    """

    amplitudes: Any = dataclasses.field(metadata=dict(static=False), default=None)
    distributors: Any = dataclasses.field(metadata=dict(static=False), default=None)

    def __init__(
        self,
        *,
        amplitudes,
        distributors,
        azm,
        offset_mean,
        xi_key,
        harmonic_transforms,
        domain,
        init,
        dist_full_shapes=None,
        dist_layouts=None,
        field_mesh=None,
        field_axis: str = "fx",
    ):
        self.amplitudes = tuple(amplitudes)
        self.distributors = tuple(distributors)
        self.dist_full_shapes = (
            (None,) * len(self.amplitudes)
            if dist_full_shapes is None
            else tuple(dist_full_shapes)
        )
        self.dist_layouts = (
            (None,) * len(self.amplitudes)
            if dist_layouts is None
            else tuple(dist_layouts)
        )
        self.azm = azm
        self.offset_mean = offset_mean
        self.xi_key = xi_key
        self.harmonic_transforms = tuple(harmonic_transforms)
        self.field_mesh = field_mesh
        self.field_axis = field_axis
        super().__init__(domain=domain, init=init)

    def _field_sharding(self, ndim):
        from jax.sharding import NamedSharding, PartitionSpec

        return NamedSharding(
            self.field_mesh,
            PartitionSpec(self.field_axis, *((None,) * (ndim - 1))),
        )

    def position_sharding(self, batch_ndim: int = 0):
        """Pytree of `NamedSharding`s over :attr:`domain` for domain-
        decomposed execution: the excitation field is sharded along its
        leading axis over the field mesh, every other (small) parameter
        is replicated.  Use with ``jax.device_put`` on positions/samples
        before calling into jitted inference code.  ``batch_ndim`` leading
        batch axes (e.g. a stacked-samples axis) are left unsharded."""
        if getattr(self, "field_mesh", None) is None:
            raise ValueError("model was finalized without a field mesh")
        from jax.sharding import NamedSharding, PartitionSpec

        rep = NamedSharding(self.field_mesh, PartitionSpec())
        out = {k: rep for k in self.domain}
        xi_ndim = len(self.domain[str(self.xi_key)].shape)
        out[str(self.xi_key)] = NamedSharding(
            self.field_mesh,
            PartitionSpec(
                *((None,) * batch_ndim),
                self.field_axis,
                *((None,) * (xi_ndim - 1)),
            ),
        )
        return out

    def __call__(self, p):
        azm = self.azm(p)
        outer = None
        fshapes = getattr(
            self, "dist_full_shapes", (None,) * len(self.amplitudes)
        )
        layouts = getattr(self, "dist_layouts", (None,) * len(self.amplitudes))
        field_mesh = getattr(self, "field_mesh", None)
        for amp, dist, fshape, layout in zip(
            self.amplitudes, self.distributors, fshapes, layouts
        ):
            if dist is None:
                # pixel-expansion amplitude: evaluated per harmonic-grid
                # pixel in closed form — no table, no gather
                if fshape is not None:
                    ea = amp.expanded_normalized_core(p, azm)
                else:
                    ea = amp.expanded_normalized(p, azm)
            else:
                a = amp(p)
                # divide the degenerate zero-mode out of each amplitude
                a = a.at[1:].mul(1.0 / azm)
                # |k| is mirror-symmetric per axis, so for Fourier grids
                # the table covers only the (n//2+1)^d core; mode_expand
                # additionally packs the core's transposition symmetry
                # (square grids) and gathers through the 2-wide-slice fast
                # path — per-index cost ~3x below a plain XLA gather, with
                # a single packed scatter-add as transpose (the metric hot
                # path; see ops/mode_expand.py)
                if layout is not None:
                    from ..ops.mode_expand import mode_expand

                    ea = mode_expand(a, dist, layout)
                else:
                    ea = a[dist]
            if fshape is not None:
                ea = _mirror_unfold(ea, fshape)
            # order matters — must match the excitation axes
            outer = ea if outer is None else jnp.tensordot(outer, ea, axes=0)
        xi = p[self.xi_key]
        if field_mesh is not None:
            # domain decomposition: amplitude grid and excitations live
            # row-sharded over the field mesh; the harmonic transform is
            # the pencil FFT with explicit all_to_all transposes
            sh = self._field_sharding(xi.ndim)
            outer = jax.lax.with_sharding_constraint(outer, sh)
            xi = jax.lax.with_sharding_constraint(xi, sh)
        out = azm * outer * xi
        for dvol, ht in self.harmonic_transforms:
            out = dvol * ht(out)
        if field_mesh is not None:
            out = jax.lax.with_sharding_constraint(
                out, self._field_sharding(out.ndim)
            )
        return self.offset_mean + out


# --- the maker ---------------------------------------------------------------


def _parse_prior(value, default_prior, what):
    if isinstance(value, (tuple, list)):
        return default_prior(*value)
    if callable(value):
        return value
    raise TypeError(f"invalid `{what}` specified; got {type(value)}")


class CorrelatedFieldMaker:
    """Builder for hierarchical correlated-field models.

    Call :meth:`add_fluctuations` once per subgrid (their spectra combine
    as an outer product), set the global offset via
    :meth:`set_amplitude_total_offset`, then :meth:`finalize`
    (reference: ``nifty/re/correlated_field.py:519``).
    """

    def __init__(self, prefix: str):
        self._azm = None
        self._offset_mean = None
        self._fluctuations = []
        self._target_grids = []
        self._parameter_tree = {}
        self._prefix = prefix

    def add_fluctuations(
        self,
        shape,
        distances,
        fluctuations,
        loglogavgslope,
        flexibility=None,
        asperity=None,
        prefix: str = "",
        harmonic_type: str = "fourier",
        non_parametric_kind: str = "amplitude",
        n_mode_knots: Optional[int] = None,
    ):
        """Add a non-parametric correlation structure on a subgrid.

        ``n_mode_knots=K`` puts the spectrum deviations on K log-spaced
        spectral knots and evaluates the amplitude per pixel (gather-free).
        ``None`` keeps the reference's exact unique-|k| mode tables."""
        grid = make_grid(
            shape, distances, harmonic_type, mode_tables=n_mode_knots is None
        )
        flu = _parse_prior(fluctuations, lognormal_prior, "fluctuations")
        slp = _parse_prior(loglogavgslope, normal_prior, "loglogavgslope")
        flx = (
            _parse_prior(flexibility, lognormal_prior, "flexibility")
            if flexibility is not None
            else None
        )
        asp = (
            _parse_prior(asperity, lognormal_prior, "asperity")
            if asperity is not None
            else None
        )
        npa = NonParametricAmplitude(
            grid=grid,
            fluctuations=flu,
            loglogavgslope=slp,
            flexibility=flx,
            asperity=asp,
            prefix=self._prefix + prefix,
            kind=non_parametric_kind,
            n_mode_knots=n_mode_knots,
        )
        self._fluctuations.append(npa)
        self._target_grids.append(grid)
        self._parameter_tree.update(npa.domain)

    def add_fluctuations_matern(
        self,
        shape,
        distances,
        scale,
        cutoff,
        loglogslope,
        renormalize_amplitude: bool,
        prefix: str = "",
        harmonic_type: str = "fourier",
        non_parametric_kind: str = "amplitude",
        pixel_expansion: bool = False,
    ):
        """Add a Matérn-kernel correlation structure on a subgrid.

        ``pixel_expansion=True`` evaluates the closed-form spectrum per
        harmonic pixel (gather-free, for large regular grids)."""
        grid = make_grid(
            shape, distances, harmonic_type, mode_tables=not pixel_expansion
        )
        scale = _parse_prior(scale, lognormal_prior, "scale")
        cutoff = _parse_prior(cutoff, lognormal_prior, "cutoff")
        loglogslope = _parse_prior(loglogslope, normal_prior, "loglogslope")
        ma = MaternAmplitude(
            grid=grid,
            scale=scale,
            cutoff=cutoff,
            loglogslope=loglogslope,
            renormalize_amplitude=renormalize_amplitude,
            prefix=self._prefix + prefix,
            kind=non_parametric_kind,
            pixel_expansion=pixel_expansion,
        )
        self._fluctuations.append(ma)
        self._target_grids.append(grid)
        self._parameter_tree.update(ma.domain)

    def set_amplitude_total_offset(self, offset_mean, offset_std):
        """Set the field's global offset and the zero-mode prior."""
        self._offset_mean = offset_mean
        zm = offset_std
        if not callable(zm):
            if zm is None or len(zm) != 2:
                raise TypeError(f"invalid `offset_std` {offset_std!r}")
            zm = lognormal_prior(*zm)
        self._azm = wrap(zm, self._prefix + "zeromode")
        self._parameter_tree[self._prefix + "zeromode"] = ShapeWithDtype(())

    @property
    def amplitude_total_offset(self) -> Callable:
        if self._azm is None:
            raise RuntimeError("set_amplitude_total_offset must be called first")
        return self._azm

    @property
    def azm(self):
        return self.amplitude_total_offset

    @property
    def fluctuations(self) -> Tuple[Callable, ...]:
        return tuple(self._fluctuations)

    def get_normalized_amplitudes(self) -> Tuple[Callable, ...]:
        """Amplitudes with the degenerate zero-mode divided out."""

        def normalize(amp):
            def normalized(p):
                a = amp(p)
                return a.at[1:].mul(1.0 / self.azm(p))

            return normalized

        return tuple(normalize(a) for a in self._fluctuations)

    @property
    def amplitude(self) -> Callable:
        if len(self._fluctuations) > 1:
            raise NotImplementedError(
                "no unique amplitude for multiple spectra; only relative"
                " scales are defined"
            )
        amp = self._fluctuations[0]

        def amplitude_with_zm(p):
            return amp(p).at[0].mul(self.azm(p))

        return amplitude_with_zm

    @property
    def power_spectrum(self) -> Callable:
        amp = self.amplitude
        return lambda p: amp(p) ** 2

    def finalize(self, field_mesh=None, field_axis: str = "fx") -> Model:
        """Assemble the model: ξ colored by the outer-product amplitude,
        mapped through the harmonic transform(s), plus the offset.

        With ``field_mesh`` (a `jax.sharding.Mesh` containing the axis
        ``field_axis``) the model executes **domain-decomposed**: the
        excitation field and correlated field are sharded along their
        leading axis over the mesh, the Hartley transform runs as a
        pencil FFT with explicit ``all_to_all`` transposes, and all
        per-pixel work / reductions partition automatically — per-device
        memory is O(N/p), the path to ≥10⁹-parameter fields (new ground
        relative to the reference, which only shards samples;
        ``SURVEY.md §5``).  Requires a single regular-Cartesian subgrid
        of ndim ≥ 2 whose two leading axes are divisible by the mesh
        axis size.  Use ``model.position_sharding()`` to place positions.
        """
        if field_mesh is not None:
            if len(self._target_grids) != 1 or not isinstance(
                self._target_grids[0], RegularCartesianGrid
            ):
                raise ValueError(
                    "field_mesh requires a single regular-Cartesian subgrid"
                )
            if len(self._target_grids[0].shape) < 2:
                raise ValueError("field_mesh requires an ndim >= 2 grid")
            psize = field_mesh.shape[field_axis]
            s0, s1 = self._target_grids[0].shape[:2]
            if s0 % psize or s1 % psize:
                raise ValueError(
                    "the two leading grid axes must be divisible by the"
                    f" field-mesh axis size {psize}"
                )
        harmonic_transforms = []
        excitation_shape = ()
        for sgrid in self._target_grids:
            sub_shp = sgrid.harmonic_grid.shape
            excitation_shape += sub_shp
            n = len(excitation_shape)
            harmonic_dvol = 1.0 / sgrid.total_volume
            if isinstance(sgrid, RegularCartesianGrid):
                if field_mesh is not None:
                    from ..parallel.fft import sharded_hartley

                    trafo = partial(
                        sharded_hartley, mesh=field_mesh, axis_name=field_axis
                    )
                else:
                    axes = tuple(range(n - len(sub_shp), n))
                    trafo = partial(hartley, axes=axes)
            elif isinstance(sgrid, HEALPixGrid):
                from ..ops.sht import get_healpix_synthesis

                trafo = get_healpix_synthesis(
                    nside=sgrid.nside,
                    axis=n - 1,
                    lmax=sgrid.harmonic_grid.lmax,
                    mmax=sgrid.harmonic_grid.mmax,
                )
            else:
                raise TypeError(f"unknown grid {sgrid!r}")
            harmonic_transforms.append((harmonic_dvol, trafo))

        xi_key = self._prefix + "xi"
        self._parameter_tree[xi_key] = ShapeWithDtype(excitation_shape)

        # int32 index tables: half the HBM of numpy's default int64, and
        # amplitude arrays are far below 2³¹ entries.  Pixel-expansion
        # amplitudes need no table at all.  For Fourier grids only the
        # non-redundant |k| octant (n//2+1 per axis) is stored/gathered and
        # the result is mirror-expanded (see `_mirror_unfold`).
        from ..ops.mode_expand import build_expand_layout

        distributors = []
        dist_full_shapes = []
        dist_layouts = []
        for a, g in zip(self._fluctuations, self._target_grids):
            if getattr(a, "pixel_mode", False):
                distributors.append(None)
                dist_full_shapes.append(tuple(g.harmonic_grid.shape))
                dist_layouts.append(None)
            elif isinstance(g, RegularCartesianGrid):
                pd = np.asarray(g.harmonic_grid.power_distributor, dtype=np.int32)
                core = pd[tuple(slice(0, n // 2 + 1) for n in pd.shape)]
                packed, layout = build_expand_layout(
                    core, int(g.harmonic_grid.mode_lengths.size)
                )
                distributors.append(packed)
                dist_full_shapes.append(tuple(pd.shape))
                dist_layouts.append(layout)
            else:
                pd = np.asarray(
                    g.harmonic_grid.power_distributor, dtype=np.int32
                )
                packed, layout = build_expand_layout(
                    pd, int(g.harmonic_grid.mode_lengths.size)
                )
                distributors.append(packed)
                dist_full_shapes.append(None)
                dist_layouts.append(layout)
        distributors = tuple(distributors)
        dist_full_shapes = tuple(dist_full_shapes)
        dist_layouts = tuple(dist_layouts)

        init = {
            k: partial(random_like, primals=v)
            for k, v in self._parameter_tree.items()
        }
        cf = CorrelatedField(
            amplitudes=tuple(self._fluctuations),
            distributors=distributors,
            azm=self.azm,
            offset_mean=self._offset_mean,
            xi_key=xi_key,
            harmonic_transforms=harmonic_transforms,
            domain=dict(self._parameter_tree),
            init=init,
            dist_full_shapes=dist_full_shapes,
            dist_layouts=dist_layouts,
            field_mesh=field_mesh,
            field_axis=field_axis,
        )
        cf.normalized_amplitudes = self.get_normalized_amplitudes()
        cf.target_grids = tuple(self._target_grids)
        return cf


def density_estimator(
    shape,
    *,
    distances=None,
    pad: float = 1.0,
    cf_fluctuations=None,
    azm_uniform=(1e-4, 1.0),
    prefix: str = "",
):
    """Exponentiated Matérn correlated field on a padded grid — the
    standard non-parametric density-estimation prior (reference:
    ``nifty/cl/sugar.py:230``).

    Returns ``(model, padded_shape)``; evaluate the model and slice
    ``[tuple(slice(0, s) for s in shape)]`` for the unpadded density.
    """
    from ..num.stats_distributions import uniform_prior

    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = (
        tuple(1.0 / s for s in shape) if distances is None else distances
    )
    distances = tuple(np.broadcast_to(distances, (len(shape),)))
    if cf_fluctuations is None:
        cf_fluctuations = dict(
            scale=(0.5, 0.3), cutoff=(4.0, 3.0), loglogslope=(-6.0, 3.0)
        )
    pshape = tuple(int(np.ceil((1.0 + pad) * s)) for s in shape)

    cfm = CorrelatedFieldMaker(prefix)
    cfm.add_fluctuations_matern(
        pshape,
        distances=distances,
        renormalize_amplitude=False,
        **cf_fluctuations,
    )
    # uniform zero-mode prior: the scale is inferred purely from the data
    cfm.set_amplitude_total_offset(
        offset_mean=0.0, offset_std=uniform_prior(*azm_uniform)
    )
    cf = cfm.finalize()

    def density(x):
        return jnp.exp(cf(x))

    model = Model(density, domain=cf.domain, init=cf.init)
    model.correlated_field = cf
    return model, pshape
