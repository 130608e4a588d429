"""Spherical-harmonic synthesis on the HEALPix sphere, in plain XLA.

Replaces the reference's ducc0 C++ SHT (bound through jaxbind,
``nifty/re/correlated_field.py:33-52``) with a pure-XLA formulation:

1. **Legendre stage** — the associated Legendre functions λ_lm(θ_r) are
   generated ring-by-ring with the stable normalized three-term
   recurrence inside one ``lax.scan`` over ℓ, fusing the coefficient
   contraction ``F_m(θ_r) = Σ_l c_lm λ_lm(θ_r)`` into the recurrence, so
   nothing of size O(lmax·mmax·n_rings) is ever materialized.
2. **Fourier stage** — iso-latitude rings are evaluated by FFT: the
   equatorial band (all rings have 4·nside pixels) as one batched
   ``ifft``; the polar-cap rings (4k pixels) via per-length alias
   folding (a matmul against a precomputed 0/1 fold matrix)
   followed by tiny batched FFTs.

Everything is linear in the coefficients and built from transposable
lax primitives, so ``jax.linear_transpose`` provides the exact adjoint
and AD "just works" inside likelihood metrics.

Conventions: real orthonormal spherical harmonics, Condon-Shortley
phase, coefficients packed as the reference's real-alm layout
(``nifty/re/correlated_field.py:70-117``): all m=0 coefficients for
ℓ=0..lmax first, then for each m≥1 the interleaved (re, im) pairs for
ℓ=m..lmax.  The synthesis is scaled by √(4π) like the reference so an
ℓ-flat unit spectrum yields unit field variance.
"""

from __future__ import annotations

from functools import partial

import numpy as np
from jax import lax
from jax import numpy as jnp
from jax import vmap

__all__ = [
    "healpix_analysis",
    "gauss_legendre_analysis",
    "gauss_legendre_grid",
    "gauss_legendre_synthesis",
    "healpix_ring_geometry",
    "healpix_synthesis",
    "get_healpix_synthesis",
    "unpack_real_alm",
]


# --- static geometry / packing tables (numpy, construction time) -------------


def healpix_ring_geometry(nside: int):
    """Ring description of the RING-ordered HEALPix grid (Górski et al.
    2005): per ring the colatitude cos θ, pixel count, first-pixel φ
    offset, and the flat start index."""
    nside = int(nside)
    n_rings = 4 * nside - 1
    z = np.empty(n_rings, dtype=np.float64)
    nphi = np.empty(n_rings, dtype=np.int64)
    phi0 = np.empty(n_rings, dtype=np.float64)
    for i in range(n_rings):
        ring = i + 1  # 1-based ring index from the north pole
        if ring < nside:  # north polar cap
            z[i] = 1.0 - ring**2 / (3.0 * nside**2)
            nphi[i] = 4 * ring
            phi0[i] = np.pi / (4.0 * ring)
        elif ring <= 3 * nside:  # equatorial belt
            z[i] = 4.0 / 3.0 - 2.0 * ring / (3.0 * nside)
            nphi[i] = 4 * nside
            s = (ring - nside + 1) % 2
            phi0[i] = s * np.pi / (4.0 * nside)
        else:  # south polar cap
            ring_s = 4 * nside - ring
            z[i] = -(1.0 - ring_s**2 / (3.0 * nside**2))
            nphi[i] = 4 * ring_s
            phi0[i] = np.pi / (4.0 * ring_s)
    start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    return z, nphi, phi0, start


def _real_alm_index_maps(lmax: int, mmax: int):
    """Gather maps from the packed real-alm vector to dense (lmax+1,
    mmax+1) matrices of cosine (re) and sine (im) coefficients."""
    idx_re = np.zeros((lmax + 1, mmax + 1), dtype=np.int64)
    idx_im = np.zeros((lmax + 1, mmax + 1), dtype=np.int64)
    msk_re = np.zeros((lmax + 1, mmax + 1), dtype=np.float64)
    msk_im = np.zeros((lmax + 1, mmax + 1), dtype=np.float64)
    for l in range(lmax + 1):
        idx_re[l, 0] = l
        msk_re[l, 0] = 1.0
    off = lmax + 1
    for m in range(1, mmax + 1):
        for l in range(m, lmax + 1):
            idx_re[l, m] = off
            idx_im[l, m] = off + 1
            msk_re[l, m] = 1.0
            msk_im[l, m] = 1.0
            off += 2
    return idx_re, msk_re, idx_im, msk_im


def unpack_real_alm(x, lmax: int, mmax: int):
    """Packed real-alm vector → dense (lmax+1, mmax+1) (cos, sin)
    coefficient matrices (two gathers on device)."""
    idx_re, msk_re, idx_im, msk_im = _real_alm_index_maps(lmax, mmax)
    c_re = x[..., jnp.asarray(idx_re)] * jnp.asarray(msk_re, dtype=x.dtype)
    c_im = x[..., jnp.asarray(idx_im)] * jnp.asarray(msk_im, dtype=x.dtype)
    return c_re, c_im


def _recurrence_tables(lmax: int, mmax: int):
    """Static coefficient tables for the normalized Legendre recurrence
    λ_{l,m} = a_{l,m} cosθ λ_{l-1,m} − b_{l,m} λ_{l-2,m}."""
    ls = np.arange(lmax + 2, dtype=np.float64)[:, None]
    ms = np.arange(mmax + 1, dtype=np.float64)[None, :]
    valid = ls >= ms + 1
    with np.errstate(divide="ignore", invalid="ignore"):
        # inverses of α_l = sqrt((l²−m²)/(4l²−1)):  cosθ λ_{l−1} =
        # α_l λ_l + α_{l−1} λ_{l−2}  ⇒  λ_l = a·cosθ·λ_{l−1} − b·λ_{l−2}
        # with a = 1/α_l and b = α_{l−1}/α_l.
        a = np.sqrt((4 * ls**2 - 1.0) / (ls**2 - ms**2))
        b = a * np.sqrt(((ls - 1.0) ** 2 - ms**2) / (4.0 * (ls - 1.0) ** 2 - 1.0))
    a = np.where(valid, a, 0.0)
    b = np.where(valid, np.nan_to_num(b), 0.0)
    # diagonal factors λ_{m,m} = dfac_m · sinθ · λ_{m-1,m-1}
    m1 = np.arange(1, lmax + 2, dtype=np.float64)
    dfac = -np.sqrt((2.0 * m1 + 1.0) / (2.0 * m1))
    return a, b, dfac


_SCAN_UNROLL = 8  # ℓ-steps per scan iteration (amortizes per-step launch)


def _scale_bits(dtype) -> int:
    """Scaled recurrence: λ = p · 2^(S · q) with an integer level q ≤ 0 per
    (ring, m) and S half the dtype's largest binary exponent (64 for
    float32, 512 for float64).  The seeds λ_mm ∝ sin^m θ fall far below the float range
    near the poles (sin^512 θ ≈ 1e-1280 on the first ring at nside 256)
    while λ_lm grows back to O(1) at larger ℓ; without the level the seeds
    flush to zero or lose their mantissa and float32 synthesis is wrong
    beyond nside ≈ 64.  Values at q < 0 are below 2^-(S/2) (2^-32 for
    float32, 2^-256 for float64) and are contracted as zero (the libsharp
    approach)."""
    return int(jnp.finfo(dtype).maxexp) // 2


def _padded_L(lmax: int) -> int:
    """Number of ℓ rows after `_legendre_scan`'s unroll padding."""
    U = _SCAN_UNROLL
    return (-(-(lmax + 1) // U)) * U


def _legendre_scan(cos_theta, sin_theta, lmax: int, mmax: int, dtype, body,
                   aux0=None):
    """Run ``body(l, lam_l, aux) -> (aux, ys)`` over ℓ = 0..lmax_pad
    inside one ``lax.scan``, where ``lam_l`` is the (n_rings, mmax+1) row
    of normalized associated Legendre functions generated by the stable
    three-term recurrence in scaled form (see ``_scale_bits``).  Shared by
    the forward contraction and its transpose — nothing of size
    O(lmax·mmax·n_rings) is materialized.

    ``_SCAN_UNROLL`` ℓ-steps run per scan iteration (the fixed cost of
    each loop iteration otherwise dominates the µs-scale body); the
    recurrence is padded past lmax (its coefficient formulas
    stay valid), so ``body`` must tolerate l in [0, lmax_pad] and callers
    must ignore stacked outputs beyond lmax.  Stacked ys come back with
    leading shape (lmax_pad+1, ...).

    The grid may carry leading batch axes (``cos_theta``/``sin_theta`` of
    shape (..., n_rings)): ``lax.while_loop`` batching broadcasts loop
    constants, so the primitive's batch rule must accept batched grids."""
    import jax

    grid_batch = cos_theta.shape[:-1]
    n_rings = cos_theta.shape[-1]
    U = _SCAN_UNROLL
    n_outer = -(-(lmax + 1) // U)
    lmax_pad = n_outer * U - 1
    a_np, b_np, dfac_np = _recurrence_tables(lmax_pad, mmax)
    a_next = jnp.asarray(a_np[1 : lmax_pad + 2], dtype=dtype)
    b_next = jnp.asarray(b_np[1 : lmax_pad + 2], dtype=dtype)
    dfac_next = jnp.asarray(dfac_np[: lmax_pad + 1], dtype=dtype)
    col = jnp.arange(mmax + 1)
    ct = cos_theta[..., :, None].astype(dtype)
    st = sin_theta.astype(dtype)
    # Near the poles the recurrence's solution depends on 1 - |cos θ|,
    # which a float cos θ mostly rounds away (a relative 1% error on the
    # first ring at nside 256 in float32).  There cos θ = ±(1 - u) with
    # u = sin²θ / (1 + |cos θ|) exact to rounding, and the step becomes
    # a·(±p) - b·p_prev ∓ a·u·p; elsewhere c2 = 0 leaves it as it was.
    polar = jnp.abs(ct) > 0.5
    one_minus = st[..., :, None] ** 2 / (1.0 + jnp.abs(ct))
    c1 = jnp.where(polar, jnp.sign(ct), ct)
    c2 = jnp.where(polar, jnp.sign(ct) * one_minus, 0.0)
    scale_bits = _scale_bits(dtype)
    hi = 2.0 ** (scale_bits // 2)
    down = jnp.asarray(2.0**-scale_bits, dtype)
    up = jnp.asarray(2.0**scale_bits, dtype)

    lam00 = 1.0 / np.sqrt(4.0 * np.pi)
    pshape = grid_batch + (n_rings, mmax + 1)
    p_prev = jnp.zeros(pshape, dtype=dtype)
    p_curr = jnp.zeros(pshape, dtype=dtype).at[..., :, 0].set(lam00)
    level = jnp.zeros(pshape, dtype=dtype)
    diag = jnp.full(grid_batch + (n_rings,), lam00, dtype=dtype)
    diag_level = jnp.zeros(grid_batch + (n_rings,), dtype=dtype)

    def step(carry, xs):
        p_prev, p_curr, level, diag, diag_level, aux = carry
        ls, a_ns, b_ns, d_ns = xs  # each (U, ...)
        ys_list = []
        for u in range(U):
            l = ls[u]
            lam = jnp.where(level == 0, p_curr, 0.0)
            aux, ys_u = body(l, lam, aux)
            ys_list.append(ys_u)
            a_p = a_ns[u] * p_curr
            p_new = (c1 * a_p - b_ns[u] * p_prev) - c2 * a_p
            # columns still below the float range move up one level once
            # their mantissa is large
            grow = (level < 0) & (jnp.abs(p_new) > hi)
            p_new = jnp.where(grow, p_new * down, p_new)
            p_curr = jnp.where(grow, p_curr * down, p_curr)
            level = level + grow.astype(dtype)
            new_diag = d_ns[u] * st * diag
            shrink = jnp.abs(new_diag) < 1.0 / hi
            new_diag = jnp.where(shrink, new_diag * up, new_diag)
            diag_level = diag_level - shrink.astype(dtype)
            sel = (col == (l + 1)) & ((l + 1) <= mmax)
            p_new = jnp.where(sel, new_diag[..., :, None], p_new)
            level = jnp.where(sel, diag_level[..., :, None], level)
            p_prev, p_curr, diag = p_curr, p_new, new_diag
        if ys_list[0] is None:
            ys = None
        else:
            ys = jax.tree_util.tree_map(
                lambda *zs: jnp.stack(zs), *ys_list
            )
        return (p_prev, p_curr, level, diag, diag_level, aux), ys

    xs = (
        jnp.arange(lmax_pad + 1).reshape(n_outer, U),
        a_next.reshape((n_outer, U) + a_next.shape[1:]),
        b_next.reshape((n_outer, U) + b_next.shape[1:]),
        dfac_next.reshape(n_outer, U),
    )
    carry = (p_prev, p_curr, level, diag, diag_level, aux0)
    (*_, aux), ys = lax.scan(step, carry, xs)
    if ys is not None:
        # (n_outer, U, ...) -> (lmax_pad+1, ...)
        ys = jax.tree_util.tree_map(
            lambda z: z.reshape((-1,) + z.shape[2:]), ys
        )
    return aux, ys


def _parity_table(lmax, mmax, dtype):
    """(-1)^(l+m) as a static (lmax+1, mmax+1) table."""
    ls = np.arange(lmax + 1)[:, None]
    ms = np.arange(mmax + 1)[None, :]
    return jnp.asarray(1.0 - 2.0 * ((ls + ms) % 2), dtype=dtype)


def _contract_core(c_re, c_im, cos_theta, sin_theta, *, lmax, mmax):
    """Unfolded forward contraction over the full ring set."""
    dtype = jnp.result_type(c_re, cos_theta)
    batch = np.broadcast_shapes(c_re.shape[:-2], cos_theta.shape[:-1])
    n_rings = cos_theta.shape[-1]
    f0 = jnp.zeros(batch + (n_rings, mmax + 1), dtype=dtype)
    cr = jnp.moveaxis(c_re, -2, 0).astype(dtype)  # (L, ..., M)
    ci = jnp.moveaxis(c_im, -2, 0).astype(dtype)
    # zero-pad ℓ rows up to the scan's unroll padding (dynamic indexing
    # clamps — padded steps must contract zeros, not the last row)
    n_pad = _padded_L(lmax) - cr.shape[0]
    if n_pad:
        zpad = jnp.zeros((n_pad,) + cr.shape[1:], dtype)
        cr = jnp.concatenate([cr, zpad])
        ci = jnp.concatenate([ci, zpad])

    def body(l, lam, aux):
        f_c, f_s = aux
        crl = cr[l][..., None, :]  # (..., 1, M)
        cil = ci[l][..., None, :]
        return (f_c + lam * crl, f_s + lam * cil), None

    (f_c, f_s), _ = _legendre_scan(
        cos_theta, sin_theta, lmax, mmax, dtype, body, aux0=(f0, f0)
    )
    return f_c, f_s


def _legendre_contract_impl(
    c_re, c_im, cos_theta, sin_theta, *, lmax, mmax, fold=False
):
    """Forward: F[..., r, m] = Σ_l c[..., l, m] λ_lm(θ_r).  Supports
    leading batch axes on the coefficients.

    With ``fold=True`` the ring grid is asserted (by the caller)
    north/south symmetric — θ_{R-1-r} = π − θ_r — and λ is generated for
    the northern half only: the southern sums follow from the parity
    λ_lm(π−θ) = (−1)^(l+m) λ_lm(θ), via a second contraction against
    parity-signed coefficients.  Contraction FLOPs are unchanged; the
    recurrence (the VPU-bound part) runs on half the rings."""
    if not fold:
        return _contract_core(
            c_re, c_im, cos_theta, sin_theta, lmax=lmax, mmax=mmax
        )
    dtype = jnp.result_type(c_re, cos_theta)
    n_rings = cos_theta.shape[-1]
    r_half = (n_rings + 1) // 2
    ct_h = cos_theta[..., :r_half]
    st_h = sin_theta[..., :r_half]
    parity = _parity_table(lmax, mmax, dtype)
    # stack (c, parity·c) as one extra leading batch axis → one scan
    cr2 = jnp.stack([c_re, c_re * parity])
    ci2 = jnp.stack([c_im, c_im * parity])
    f_c2, f_s2 = _contract_core(cr2, ci2, ct_h, st_h, lmax=lmax, mmax=mmax)

    def unfold(f2):
        north = f2[0]
        south = jnp.flip(f2[1][..., : r_half - 1, :], axis=-2)
        return jnp.concatenate([north, south], axis=-2)

    return unfold(f_c2), unfold(f_s2)


def _transpose_core(cot_c, cot_s, cos_theta, sin_theta, *, lmax, mmax):
    dtype = jnp.result_type(cot_c, cos_theta)
    cc = cot_c.astype(dtype)
    cs = cot_s.astype(dtype)

    def body(l, lam, aux):
        g_re = jnp.sum(lam * cc, axis=-2)  # (..., M)
        g_im = jnp.sum(lam * cs, axis=-2)
        return aux, (g_re, g_im)

    _, (g_re, g_im) = _legendre_scan(
        cos_theta, sin_theta, lmax, mmax, dtype, body
    )
    # scan stacks over ℓ at axis 0 (incl. unroll padding) → slice + move
    g_re = g_re[: lmax + 1]
    g_im = g_im[: lmax + 1]
    return jnp.moveaxis(g_re, 0, -2), jnp.moveaxis(g_im, 0, -2)


def _legendre_contract_transpose(
    cot_c, cot_s, cos_theta, sin_theta, *, lmax, mmax, fold=False
):
    """Transpose: g[..., l, m] = Σ_r λ_lm(θ_r) cot[..., r, m] (with the
    same optional hemisphere fold as the forward)."""
    if not fold:
        return _transpose_core(
            cot_c, cot_s, cos_theta, sin_theta, lmax=lmax, mmax=mmax
        )
    dtype = jnp.result_type(cot_c, cos_theta)
    n_rings = cos_theta.shape[-1]
    r_half = (n_rings + 1) // 2
    ct_h = cos_theta[..., :r_half]
    st_h = sin_theta[..., :r_half]

    def fold_cot(cot):
        north = cot[..., :r_half, :]
        south = jnp.flip(cot[..., r_half:, :], axis=-2)
        pad = [(0, 0)] * (south.ndim - 2) + [(0, 1), (0, 0)]
        south = jnp.pad(south, pad)  # zero row at the equator position
        return jnp.stack([north, south])

    g_re2, g_im2 = _transpose_core(
        fold_cot(cot_c), fold_cot(cot_s), ct_h, st_h, lmax=lmax, mmax=mmax
    )
    parity = _parity_table(lmax, mmax, dtype)
    g_re = g_re2[0] + parity * g_re2[1]
    g_im = g_im2[0] + parity * g_im2[1]
    return g_re, g_im


def _make_legendre_primitive():
    """Legendre-recurrence contraction as a primitive with a custom
    transpose: ``lax.scan`` cannot carry linear values through
    ``jax.linear_transpose`` (the new-AD transposition interprets only
    elementwise/reduce ops on its accumulator stand-ins), so both
    directions are expressed as scans over *concrete* operands inside
    primitive rules instead.  This removes the unrolled ℓ-block loop the
    pre-round-5 implementation needed (whose HLO grew linearly in lmax —
    untenable at lmax ≥ 1024) and bounds peak memory at O(n_rings·mmax)
    for any lmax."""
    from jax.extend.core import Primitive
    import jax
    from jax.interpreters import ad, batching, mlir

    prim = Primitive("nifty_legendre_contract")
    prim.multiple_results = True

    def _impl(c_re, c_im, ct, st, *, lmax, mmax, fold):
        return _legendre_contract_impl(
            c_re, c_im, ct, st, lmax=lmax, mmax=mmax, fold=fold
        )

    prim.def_impl(_impl)

    def _abstract(c_re, c_im, ct, st, *, lmax, mmax, fold):
        dtype = jnp.result_type(c_re.dtype, ct.dtype)
        batch = np.broadcast_shapes(c_re.shape[:-2], ct.shape[:-1])
        shape = batch + (ct.shape[-1], mmax + 1)
        return (
            jax.core.ShapedArray(shape, dtype),
            jax.core.ShapedArray(shape, dtype),
        )

    prim.def_abstract_eval(_abstract)

    def _jvp(primals, tangents, *, lmax, mmax, fold):
        c_re, c_im, ct, st = primals
        t_re, t_im, t_ct, t_st = tangents
        is_zero = lambda t: type(t) is ad.Zero  # noqa: E731
        if not (is_zero(t_ct) and is_zero(t_st)):
            raise NotImplementedError(
                "legendre_contract is not differentiable w.r.t. the grid"
            )
        out = prim.bind(c_re, c_im, ct, st, lmax=lmax, mmax=mmax, fold=fold)
        zero = jnp.zeros_like(c_re)
        t_out = prim.bind(
            zero if is_zero(t_re) else t_re,
            zero if is_zero(t_im) else t_im,
            ct, st, lmax=lmax, mmax=mmax, fold=fold,
        )
        return out, t_out

    ad.primitive_jvps[prim] = _jvp

    def _transpose(cots, c_re, c_im, ct, st, *, lmax, mmax, fold):
        if ad.is_undefined_primal(ct) or ad.is_undefined_primal(st):
            raise NotImplementedError("transpose w.r.t. grid")
        cot_c, cot_s = cots
        proto_shape = (
            c_re.aval.shape if ad.is_undefined_primal(c_re) else c_re.shape
        )
        if type(cot_c) is ad.Zero:
            batch = np.broadcast_shapes(proto_shape[:-2], ct.shape[:-1])
            cot_c = jnp.zeros(
                batch + (ct.shape[-1], mmax + 1), ct.dtype
            )
        if type(cot_s) is ad.Zero:
            cot_s = jnp.zeros_like(cot_c)
        g_re, g_im = _legendre_contract_transpose(
            cot_c, cot_s, ct, st, lmax=lmax, mmax=mmax, fold=fold
        )
        return g_re, g_im, None, None

    ad.primitive_transposes[prim] = _transpose

    def _batch(args, dims, *, lmax, mmax, fold):
        # grid operands may arrive batched too: lax.while_loop batching
        # broadcasts loop constants, so ct/st can carry the batch axis
        c_re, c_im, ct, st = args
        not_mapped = batching.not_mapped
        def to_front(x, d):
            return x if d is not_mapped else jnp.moveaxis(x, d, 0)
        c_re, c_im, ct, st = map(to_front, args, dims)
        out = prim.bind(c_re, c_im, ct, st, lmax=lmax, mmax=mmax, fold=fold)
        return out, (0, 0)

    batching.primitive_batchers[prim] = _batch
    mlir.register_lowering(
        prim, mlir.lower_fun(_impl, multiple_results=True)
    )
    return prim


_legendre_contract_p = _make_legendre_primitive()


def _legendre_contract(
    cos_theta, sin_theta, c_re, c_im, lmax: int, mmax: int,
    fold: bool = False,
):
    """Legendre recurrence + coefficient contraction.

    Returns ``(Fc, Fs)`` of shape (n_rings, mmax+1) with
    ``Fc[r, m] = Σ_l c_re[l, m] λ_lm(θ_r)`` (same for sin/c_im).

    A single ``lax.scan`` over ℓ fuses the recurrence with the
    contraction (nothing of size O(lmax·mmax·n_rings) is materialized);
    transposition and batching go through the registered primitive rules
    (see :func:`_make_legendre_primitive`).
    """
    dtype = jnp.result_type(c_re, cos_theta)
    return _legendre_contract_p.bind(
        jnp.asarray(c_re, dtype),
        jnp.asarray(c_im, dtype),
        jnp.asarray(cos_theta, dtype),
        jnp.asarray(sin_theta, dtype),
        lmax=int(lmax),
        mmax=int(mmax),
        fold=bool(fold),
    )


# --- ring Fourier stage ------------------------------------------------------


def _cap_synthesis(f_c, f_s, ring_idx, nphi, phi0, mmax, w_np, chunk=8):
    """Evaluate all polar-cap rings (ragged lengths 4k) in one scanned,
    batched pass — in place of per-ring-length fold matrices + tiny FFTs (which cost one compiled program per distinct
    ring length, untenable beyond nside ≈ 64).

    Ring values are a factored direct DFT:  with m = m1 + S·m2,

        f(φ) = Σ_m w_m (c_m cos mφ − s_m sin mφ)
             = Re Σ_{m2} e^{iS m2 φ} Σ_{m1} (wc + i ws)[m1+S·m2] e^{i m1 φ}

    so each ring chunk is two small batched matmuls over m1 plus an
    elementwise combine over m2 — O((mmax+1)·L) MACs per ring with only
    O((S + mmax/S)·L) transcendentals.  The ragged (4k-pixel) rings are
    flattened with static per-ring slices joined by one final
    ``concatenate`` — no gather/scatter.

    Everything used here is a transposable lax primitive, so the exact
    adjoint comes from ``jax.linear_transpose``.

    Parameters: ``f_c``/``f_s`` are the full (n_rings, mmax+1) Legendre
    sums; ``ring_idx`` the cap ring indices **in map order**; ``nphi``/
    ``phi0`` the per-cap-ring pixel counts and first-pixel offsets.
    Returns the flat concatenation of the cap rings in that order.
    """
    dtype = f_c.dtype
    R = len(ring_idx)
    if R == 0:
        return jnp.zeros((0,), dtype)
    M = mmax + 1
    S = min(16, M)
    M2 = -(-M // S)
    L = int(np.max(nphi))
    L = max(128, -(-L // 128) * 128)  # lane-pad
    chunk = min(chunk, R)

    # static angle tables, range-reduced in f64 *before* the cast so that
    # m·φ stays f32-accurate: ang1 = φ_j mod 2π feeds the m1 < S factors,
    # ang2 = (S·φ_j) mod 2π the coarse e^{iS m2 φ} factors
    jj = np.arange(L, dtype=np.float64)[None, :]
    phi = np.asarray(phi0)[:, None] + (
        2.0 * np.pi / np.asarray(nphi, dtype=np.float64)[:, None]
    ) * jj
    ang1_np = np.mod(phi, 2.0 * np.pi)
    ang2_np = np.mod(S * phi, 2.0 * np.pi)

    wc = f_c[jnp.asarray(ring_idx)] * jnp.asarray(w_np, dtype)[None, :]
    ws = f_s[jnp.asarray(ring_idx)] * jnp.asarray(w_np, dtype)[None, :]
    pad = ((0, 0), (0, M2 * S - M))
    C1 = jnp.pad(wc, pad).reshape(R, M2, S)
    C2 = jnp.pad(ws, pad).reshape(R, M2, S)

    m1 = jnp.arange(S, dtype=dtype)[None, :, None]
    m2 = jnp.arange(M2, dtype=dtype)[None, :, None]

    # blocked python loop (NOT lax.scan: linear values in scan xs break
    # jax.linear_transpose); per block two batched contractions over
    # m1 plus an elementwise combine over m2
    parts = []
    for r0 in range(0, R, chunk):
        r1 = min(r0 + chunk, R)
        a1 = jnp.asarray(ang1_np[r0:r1], dtype)[:, None, :]  # (C,1,L)
        a2 = jnp.asarray(ang2_np[r0:r1], dtype)[:, None, :]
        c1 = C1[r0:r1]
        c2 = C2[r0:r1]
        hp = lax.Precision.HIGHEST
        t1c = jnp.cos(m1 * a1)
        t1s = jnp.sin(m1 * a1)
        zc = jnp.einsum("cns,csl->cnl", c1, t1c, precision=hp) - jnp.einsum(
            "cns,csl->cnl", c2, t1s, precision=hp
        )
        zs = jnp.einsum("cns,csl->cnl", c1, t1s, precision=hp) + jnp.einsum(
            "cns,csl->cnl", c2, t1c, precision=hp
        )
        t2c = jnp.cos(m2 * a2)
        t2s = jnp.sin(m2 * a2)
        vals = jnp.einsum("cnl,cnl->cl", zc, t2c, precision=hp) - jnp.einsum(
            "cnl,cnl->cl", zs, t2s, precision=hp
        )
        # ragged flatten: static per-ring slices, one final concatenate
        for c in range(r1 - r0):
            parts.append(vals[c, : int(nphi[r0 + c])])
    return jnp.concatenate(parts)


def healpix_synthesis(alm, nside: int, lmax=None, mmax=None):
    """Spherical-harmonic synthesis: packed real alm → RING-ordered
    HEALPix map of 12·nside² pixels.  Linear and transposable."""
    nside = int(nside)
    lmax = 2 * nside if lmax is None else int(lmax)
    mmax = lmax if mmax is None else int(mmax)
    dtype = alm.dtype
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

    z, nphi, phi0, _ = healpix_ring_geometry(nside)
    n_rings = z.size
    sin_theta = jnp.asarray(np.sqrt(1.0 - z**2), dtype=dtype)
    cos_theta = jnp.asarray(z, dtype=dtype)

    c_re, c_im = unpack_real_alm(alm, lmax, mmax)
    # HEALPix ring grids are north/south symmetric: generate λ for the
    # northern hemisphere only (λ(π−θ) = (−1)^(l+m) λ(θ))
    assert np.allclose(z, -z[::-1]), "ring grid not north/south symmetric"
    f_c, f_s = _legendre_contract(
        cos_theta, sin_theta, c_re, c_im, lmax, mmax, fold=True
    )

    # real-basis weights (+ the reference's global √(4π) synthesis scale)
    ms = np.arange(mmax + 1)
    w = np.full(mmax + 1, np.sqrt(2.0))
    w[0] = 1.0
    w *= np.sqrt(4.0 * np.pi)

    # --- equatorial belt: one batched ifft (no aliasing: mmax < 4 nside)
    n_eq = 4 * nside
    eq_lo, eq_hi = nside - 1, 3 * nside - 1  # 0-based ring indices, inclusive
    phase = np.exp(1j * ms[None, :] * phi0[eq_lo : eq_hi + 1, None]) * w[None, :]
    g_eq = (f_c[eq_lo : eq_hi + 1] + 1j * f_s[eq_lo : eq_hi + 1]).astype(
        cdtype
    ) * jnp.asarray(phase, dtype=cdtype)
    h_eq = jnp.zeros((g_eq.shape[0], n_eq), dtype=cdtype)
    h_eq = h_eq.at[:, : mmax + 1].set(g_eq)
    f_eq = n_eq * jnp.real(jnp.fft.ifft(h_eq, axis=-1))

    # --- polar caps: batched factored DFT over all ragged rings
    north = list(range(0, nside - 1))
    south = list(range(3 * nside, n_rings))
    cap_idx = north + south
    if cap_idx:
        f_cap = _cap_synthesis(
            f_c, f_s, cap_idx, nphi[cap_idx], phi0[cap_idx], mmax, w
        )
        n_north = int(np.sum(nphi[north]))
        parts = [f_cap[:n_north], f_eq.reshape(-1), f_cap[n_north:]]
    else:
        parts = [f_eq.reshape(-1)]
    return jnp.concatenate(parts).astype(dtype)


def get_healpix_synthesis(nside, axis, lmax, mmax):
    """Return a synthesis callable applying over `axis` of an nd-array,
    vmapped over all other axes (interface parity with the reference's
    ``get_sht``, ``nifty/re/correlated_field.py:33-52``)."""
    core = partial(healpix_synthesis, nside=nside, lmax=lmax, mmax=mmax)
    axis = int(axis)

    def f(inp):
        trafo = core
        axs = axis % inp.ndim
        for i in reversed(range(inp.ndim)):
            if i < axs:
                trafo = vmap(trafo, in_axes=0, out_axes=0)
            elif i > axs:
                trafo = vmap(trafo, in_axes=1, out_axes=1)
        return trafo(inp)

    return f


# --- Gauss-Legendre grid (exact quadrature) ----------------------------------


def _legendre_rows(cos_theta, sin_theta, lmax: int, mmax: int, dtype):
    """All λ rows stacked: (lmax+1, n_rings, mmax+1) via the same blocked
    recurrence used by :func:`_legendre_contract` (testing / analysis)."""
    n_rings = cos_theta.shape[0]
    a_np, b_np, dfac_np = _recurrence_tables(lmax, mmax)
    a_next = jnp.asarray(a_np[1 : lmax + 2], dtype=dtype)
    b_next = jnp.asarray(b_np[1 : lmax + 2], dtype=dtype)
    dfac_next = jnp.asarray(dfac_np[: lmax + 1], dtype=dtype)
    col = jnp.arange(mmax + 1)
    ct = cos_theta[:, None].astype(dtype)
    st = sin_theta.astype(dtype)
    lam00 = 1.0 / np.sqrt(4.0 * np.pi)
    p_prev = jnp.zeros((n_rings, mmax + 1), dtype=dtype)
    p_curr = jnp.zeros((n_rings, mmax + 1), dtype=dtype).at[:, 0].set(lam00)
    diag = jnp.full((n_rings,), lam00, dtype=dtype)

    def step(carry, xs):
        p_prev, p_curr, diag = carry
        l, a_n, b_n, d_n = xs
        p_new = a_n[None, :] * ct * p_curr - b_n[None, :] * p_prev
        new_diag = d_n * st * diag
        sel = col[None, :] == (l + 1)
        p_new = jnp.where(sel & ((l + 1) <= mmax), new_diag[:, None], p_new)
        return (p_curr, p_new, new_diag), p_curr

    xs = (jnp.arange(lmax + 1), a_next, b_next, dfac_next)
    _, lam = lax.scan(step, (p_prev, p_curr, diag), xs)
    return lam  # (lmax+1, n_rings, mmax+1)


def gauss_legendre_grid(lmax: int, n_phi=None):
    """Gauss–Legendre sphere pixelization: ``lmax+1`` iso-latitude rings
    at the Legendre nodes (quadrature-exact up to degree 2·lmax+1) ×
    ``n_phi`` equidistant pixels (default 2·lmax+2).

    Returns (cos θ nodes, quadrature weights, n_phi)."""
    nodes, weights = np.polynomial.legendre.leggauss(lmax + 1)
    n_phi = 2 * lmax + 2 if n_phi is None else int(n_phi)
    # north → south ordering like the HEALPix routines
    return nodes[::-1].copy(), weights[::-1].copy(), n_phi


def gauss_legendre_synthesis(alm, lmax: int, mmax=None, n_phi=None):
    """Real-alm synthesis onto the Gauss–Legendre grid: one Legendre
    contraction + one batched FFT (every ring has the same length —
    the fully regular, matmul/FFT-friendly sphere)."""
    lmax = int(lmax)
    mmax = lmax if mmax is None else int(mmax)
    z, _, n_phi = gauss_legendre_grid(lmax, n_phi)
    if mmax >= n_phi:
        raise ValueError("n_phi must exceed mmax (no aliasing allowed)")
    dtype = alm.dtype
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    cos_theta = jnp.asarray(z, dtype=dtype)
    sin_theta = jnp.asarray(np.sqrt(1.0 - z**2), dtype=dtype)
    c_re, c_im = unpack_real_alm(alm, lmax, mmax)
    # HEALPix ring grids are north/south symmetric: generate λ for the
    # northern hemisphere only (λ(π−θ) = (−1)^(l+m) λ(θ))
    assert np.allclose(z, -z[::-1]), "ring grid not north/south symmetric"
    f_c, f_s = _legendre_contract(
        cos_theta, sin_theta, c_re, c_im, lmax, mmax, fold=True
    )
    w = np.full(mmax + 1, np.sqrt(2.0))
    w[0] = 1.0
    w *= np.sqrt(4.0 * np.pi)
    g = (f_c + 1j * f_s).astype(cdtype) * jnp.asarray(w, dtype=dtype)
    h = jnp.zeros((z.size, n_phi), dtype=cdtype).at[:, : mmax + 1].set(g)
    return n_phi * jnp.real(jnp.fft.ifft(h, axis=-1)).astype(dtype)


def gauss_legendre_analysis(f, lmax: int, mmax=None):
    """Exact inverse of :func:`gauss_legendre_synthesis` for band-limited
    maps: ring FFT + Gauss-quadrature-weighted Legendre projection."""
    lmax = int(lmax)
    mmax = lmax if mmax is None else int(mmax)
    z, wq, n_phi = gauss_legendre_grid(lmax, f.shape[-1])
    dtype = f.dtype
    cos_theta = jnp.asarray(z, dtype=dtype)
    sin_theta = jnp.asarray(np.sqrt(1.0 - z**2), dtype=dtype)

    # ring Fourier coefficients:  G_m(θ_r) = (2π/n_phi) Σ_j f_rj e^{-imφ_j}
    ft = jnp.fft.fft(f, axis=-1)[:, : mmax + 1] * (2.0 * np.pi / n_phi)
    w = np.full(mmax + 1, np.sqrt(2.0))
    w[0] = 1.0
    w *= np.sqrt(4.0 * np.pi)
    # undo the synthesis weights and apply quadrature in cos θ
    g = ft / jnp.asarray(w, dtype=dtype) * jnp.asarray(wq, dtype=dtype)[:, None]
    g_c = jnp.real(g)
    g_s = jnp.imag(g)

    lam = _legendre_rows(cos_theta, sin_theta, lmax, mmax, dtype)
    # m ≥ 1 columns carry ∮cos² dφ = π (not 2π): compensate by 2
    scale = np.full(mmax + 1, 2.0)
    scale[0] = 1.0
    hp = lax.Precision.HIGHEST
    c_re = jnp.einsum("lrm,rm->lm", lam, g_c, precision=hp) * jnp.asarray(
        scale, dtype=dtype
    )
    c_im = jnp.einsum("lrm,rm->lm", lam, g_s, precision=hp) * jnp.asarray(
        scale, dtype=dtype
    )
    # Gauss-Legendre quadrature integrates dcosθ; the orthonormal-Y
    # normalization is already inside λ, so Σ_r wq λλ = δ/(2π)·... the
    # 2π φ-integral is in `ft`; collect into packed real alm
    idx_re, msk_re, idx_im, msk_im = _real_alm_index_maps(lmax, mmax)
    size = (lmax + 1) ** 2 - (lmax - mmax) * (lmax - mmax + 1)
    out = jnp.zeros((size,), dtype=dtype)
    lgrid, mgrid = np.meshgrid(
        np.arange(lmax + 1), np.arange(mmax + 1), indexing="ij"
    )
    sel = msk_re > 0
    out = out.at[idx_re[sel]].set(c_re[sel])
    sel_im = msk_im > 0
    out = out.at[idx_im[sel_im]].set(c_im[sel_im])
    return out


def healpix_analysis(
    m, nside: int, lmax=None, mmax=None, *, iterations: int = 3
):
    """Spherical-harmonic *analysis* (map → real-alm packing), the inverse
    of :func:`healpix_synthesis`.

    HEALPix is equal-area but not an exact quadrature grid, so the
    weighted adjoint ``(4π/npix)·Sᵀ`` is only approximate and plain
    Jacobi refinement diverges for the poorly-sampled modes near lmax.
    Instead the normal equations ``SᵀS·alm = Sᵀm`` are solved with
    (static, jittable) conjugate gradient — the least-squares alm, exact
    for maps in the synthesis range.  Everything is built from the same
    Legendre-recurrence matmuls — on-device, differentiable,
    transposable.

    Stopping is residual-based (CG stops at ``‖r‖ < 1e-6·‖Sᵀm‖``);
    `iterations` only scales the iteration *cap* (``10·iterations``), so
    raising it never changes a converged answer.  Tolerance behavior
    (measured, ``tests/test_sht.py``): red spectra (ℓ^−1.5) reach <1e-3
    relative alm error within the default cap at lmax = 2·nside; flat and
    blue (ℓ^+1) spectra concentrate power in the poorly-sampled modes
    near lmax where the normal equations are worse-conditioned and need
    ``iterations≈8`` for the same 1e-3 at lmax = 2·nside (verified at
    nside 64 and 256).  For lmax ≤ 1.5·nside the system is
    well-conditioned and a handful of iterations suffice for any
    spectrum.
    """
    import jax

    from ..conjugate_gradient import static_cg

    nside = int(nside)
    lmax = 2 * nside if lmax is None else int(lmax)
    mmax = lmax if mmax is None else int(mmax)
    npix = 12 * nside * nside
    w = 4.0 * np.pi / npix

    def synth(alm):
        return healpix_synthesis(alm, nside, lmax=lmax, mmax=mmax)

    size = (lmax + 1) ** 2 - (lmax - mmax) * (lmax - mmax + 1)
    proto = jax.ShapeDtypeStruct((size,), m.dtype)
    adjoint = jax.linear_transpose(synth, proto)

    def wadj(x):
        (alm,) = adjoint(x)
        return w * alm

    def normal_op(alm):
        return wadj(synth(alm))

    b = wadj(m)
    res = static_cg(
        normal_op,
        b,
        x0=b,
        maxiter=max(int(iterations), 1) * 10,
        resnorm=1e-6 * jnp.linalg.norm(b),
        miniter=2,
    )
    return res.x
