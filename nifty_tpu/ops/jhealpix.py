"""Pure-JAX HEALPix pixelization (RING scheme) — jit/vmap-compatible.

Device-side counterpart of :mod:`nifty_tpu.native`: the same published
algorithms (Górski et al. 2005) written in branch-free jnp so they can
run inside traced code (e.g. sampling responses that bin sky
coordinates on the fly).  NEST bit-interleaving and neighbor tables
stay host-side in the native module — they are construction-time
operations.

Parity with ``nifty/re/multi_grid/jhealpix.py`` (ang2pix/pix2ang);
independent implementation.
"""

from __future__ import annotations

import jax
import numpy as np
from jax import numpy as jnp

__all__ = [
    "ang2pix_ring",
    "neighbors",
    "nest2ring",
    "npix",
    "pix2ang_ring",
    "ring2nest",
]


def npix(nside: int) -> int:
    return 12 * int(nside) ** 2


def ang2pix_ring(nside: int, z, phi):
    """(z = cos θ, φ) → RING pixel index; fully vectorized jnp."""
    nside = int(nside)
    z = jnp.asarray(z)
    phi = jnp.asarray(phi)
    za = jnp.abs(z)
    tt = jnp.mod(phi / (0.5 * jnp.pi), 4.0)
    total = npix(nside)

    # equatorial belt
    t1 = nside * (0.5 + tt)
    t2 = nside * 0.75 * z
    jp_e = jnp.floor(t1 - t2).astype(jnp.int64)
    jm_e = jnp.floor(t1 + t2).astype(jnp.int64)
    ir_e = nside + 1 + jp_e - jm_e
    kshift = 1 - (ir_e & 1)
    ip_e = jnp.mod((jp_e + jm_e - nside + kshift + 1) // 2, 4 * nside)
    pix_e = 2 * nside * (nside - 1) + (ir_e - 1) * 4 * nside + ip_e

    # polar caps
    tp = tt - jnp.floor(tt)
    tmp = nside * jnp.sqrt(jnp.maximum(3.0 * (1.0 - za), 0.0))
    jp_c = jnp.floor(tp * tmp).astype(jnp.int64)
    jm_c = jnp.floor((1.0 - tp) * tmp).astype(jnp.int64)
    ir_c = jp_c + jm_c + 1
    ip_c = jnp.mod(jnp.floor(tt * ir_c).astype(jnp.int64), 4 * ir_c)
    pix_n = 2 * ir_c * (ir_c - 1) + ip_c
    pix_s = total - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = jnp.where(z > 0, pix_n, pix_s)

    return jnp.where(za <= 2.0 / 3.0, pix_e, pix_cap)


def pix2ang_ring(nside: int, pix):
    """RING pixel index → (z = cos θ, φ); fully vectorized jnp."""
    nside = int(nside)
    pix = jnp.asarray(pix, dtype=jnp.int64)
    ncap = 2 * nside * (nside - 1)
    total = npix(nside)

    # north cap
    ir_n = (0.5 * (1.0 + jnp.sqrt(jnp.maximum(1.0 + 2.0 * pix, 1.0)))).astype(
        jnp.int64
    )
    iphi_n = pix + 1 - 2 * ir_n * (ir_n - 1)
    z_n = 1.0 - ir_n.astype(float) ** 2 / (3.0 * nside**2)
    phi_n = (iphi_n - 0.5) * jnp.pi / (2.0 * jnp.maximum(ir_n, 1))

    # equatorial
    ip = pix - ncap
    ir_e = ip // (4 * nside) + nside
    iphi_e = jnp.mod(ip, 4 * nside) + 1
    fodd = jnp.where((ir_e + nside) & 1, 1.0, 0.5)
    z_e = (2.0 * nside - ir_e) * 2.0 / (3.0 * nside)
    phi_e = (iphi_e - fodd) * jnp.pi / (2.0 * nside)

    # south cap
    ip_s = total - pix
    ir_s = (0.5 * (1.0 + jnp.sqrt(jnp.maximum(2.0 * ip_s - 1.0, 1.0)))).astype(
        jnp.int64
    )
    iphi_s = 4 * ir_s + 1 - (ip_s - 2 * ir_s * (ir_s - 1))
    z_s = -1.0 + ir_s.astype(float) ** 2 / (3.0 * nside**2)
    phi_s = (iphi_s - 0.5) * jnp.pi / (2.0 * jnp.maximum(ir_s, 1))

    north = pix < ncap
    south = pix >= total - ncap
    z = jnp.where(north, z_n, jnp.where(south, z_s, z_e))
    phi = jnp.where(north, phi_n, jnp.where(south, phi_s, phi_e))
    return z, phi


# --- NEST scheme + neighbors (device-side, batch-vectorized) ------------------
#
# Published HEALPix face geometry (Górski et al. 2005; healpix C reference):
# JRLL/JPLL locate each base face's ring origin; the NB_* tables encode the
# face adjacency used for cross-face neighbor lookups.  In contrast to the
# reference's scalar `lax.cond` formulation (``nifty/re/multi_grid/
# jhealpix.py:299-534``, written for per-element vmap), everything below is
# branch-free and batch-vectorized: all case formulas are evaluated and
# `where`-selected, so a single call handles arbitrarily-shaped pixel
# arrays with uniform control flow.

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])

_NB_XOFFSET = np.array([-1, -1, 0, 1, 1, 1, 0, -1])
_NB_YOFFSET = np.array([0, 1, 1, 1, 0, -1, -1, -1])
_NB_FACEARRAY = np.array(
    [
        [8, 9, 10, 11, -1, -1, -1, -1, 10, 11, 8, 9],  # S
        [5, 6, 7, 4, 8, 9, 10, 11, 9, 10, 11, 8],  # SE
        [-1, -1, -1, -1, 5, 6, 7, 4, -1, -1, -1, -1],  # E
        [4, 5, 6, 7, 11, 8, 9, 10, 11, 8, 9, 10],  # SW
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],  # center
        [1, 2, 3, 0, 0, 1, 2, 3, 5, 6, 7, 4],  # NE
        [-1, -1, -1, -1, 7, 4, 5, 6, -1, -1, -1, -1],  # W
        [3, 0, 1, 2, 3, 0, 1, 2, 4, 5, 6, 7],  # NW
        [2, 3, 0, 1, -1, -1, -1, -1, 0, 1, 2, 3],  # N
    ]
)
_NB_SWAPARRAY = np.array(
    [
        [0, 0, 3],  # S
        [0, 0, 6],  # SE
        [0, 0, 0],  # E
        [0, 0, 5],  # SW
        [0, 0, 0],  # center
        [5, 0, 0],  # NE
        [0, 0, 0],  # W
        [6, 0, 0],  # NW
        [3, 0, 0],  # N
    ]
)

_I = jnp.int32  # int32 covers every practical nside (≤ 8192 ⇒ npix < 2³¹)


def _spread_bits(v):
    """Interleave zeros between the low 16 bits (Morton encoding)."""
    v = jnp.asarray(v, _I) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _compress_bits(v):
    """Inverse of :func:`_spread_bits` (keep even-position bits)."""
    v = jnp.asarray(v, _I) & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def _isqrt(v):
    """Exact integer sqrt for int32-range values (float sqrt + fixup)."""
    v = jnp.maximum(jnp.asarray(v, _I), 0)
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    r = jnp.floor(jnp.sqrt(v.astype(ftype))).astype(_I)
    r = jnp.where((r + 1) * (r + 1) <= v, r + 1, r)
    r = jnp.where(r * r > v, r - 1, r)
    return r


def _div_floor(a, b):
    """C-style floor division for possibly-negative numerators."""
    return jnp.floor_divide(a, b)


def nest2hpd(nside: int, pix):
    """NEST pixel → (x, y, face) discrete face coordinates."""
    pix = jnp.asarray(pix, _I)
    npface = _I(nside * nside)
    p2 = pix & (npface - 1)
    return _compress_bits(p2), _compress_bits(p2 >> 1), pix // npface


def hpd2nest(nside: int, x, y, f):
    return (
        jnp.asarray(f, _I) * _I(nside * nside)
        + _spread_bits(x)
        + (_spread_bits(y) << 1)
    )


def ring2hpd(nside: int, pix):
    """RING pixel → (x, y, face), all three regions evaluated branch-free."""
    nside = int(nside)
    pix = jnp.asarray(pix, _I)
    ncap = _I(2 * nside * (nside - 1))
    ntot = _I(12 * nside * nside)
    jrll = jnp.asarray(_JRLL, _I)
    jpll = jnp.asarray(_JPLL, _I)

    # north polar cap
    iring_n = (1 + _isqrt(1 + 2 * jnp.minimum(pix, ncap - 1))) >> 1
    iring_n = jnp.maximum(iring_n, 1)
    iphi_n = (pix + 1) - 2 * iring_n * (iring_n - 1)
    face_n = _div_floor(iphi_n - 1, iring_n)
    face_n = jnp.clip(face_n, 0, 3)
    irt_n = iring_n - jrll[face_n] * nside + 1
    ipt_n = 2 * iphi_n - jpll[face_n] * iring_n - 1
    ipt_n = jnp.where(ipt_n >= 2 * nside, ipt_n - 8 * nside, ipt_n)

    # equatorial belt
    ip = pix - ncap
    iring_e = _div_floor(ip, 4 * nside) + nside
    iphi_e = jnp.mod(ip, 4 * nside) + 1
    kshift = (iring_e + nside) & 1
    ire = iring_e - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = _div_floor(iphi_e - _div_floor(ire, 2) + nside - 1, nside)
    ifp = _div_floor(iphi_e - _div_floor(irm, 2) + nside - 1, nside)
    face_e = jnp.where(ifp == ifm, jnp.mod(ifp, 4) + 4, jnp.where(ifp < ifm, ifp, ifm + 8))
    face_e = jnp.clip(face_e, 0, 11)
    irt_e = iring_e - jrll[face_e] * nside + 1
    ipt_e = 2 * iphi_e - jpll[face_e] * nside - kshift - 1
    ipt_e = jnp.where(ipt_e >= 2 * nside, ipt_e - 8 * nside, ipt_e)

    # south polar cap
    ip_s = ntot - pix
    iring_s = (1 + _isqrt(2 * jnp.maximum(ip_s, 1) - 1)) >> 1
    iring_s = jnp.maximum(iring_s, 1)
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    face_s = jnp.clip(8 + _div_floor(iphi_s - 1, iring_s), 8, 11)
    irt_s = 4 * nside - iring_s - jrll[face_s] * nside + 1
    ipt_s = 2 * iphi_s - jpll[face_s] * iring_s - 1
    ipt_s = jnp.where(ipt_s >= 2 * nside, ipt_s - 8 * nside, ipt_s)

    north = pix < ncap
    south = pix >= ntot - ncap
    irt = jnp.where(north, irt_n, jnp.where(south, irt_s, irt_e))
    ipt = jnp.where(north, ipt_n, jnp.where(south, ipt_s, ipt_e))
    face = jnp.where(north, face_n, jnp.where(south, face_s, face_e))
    x = (ipt - irt) >> 1
    y = (-(ipt + irt)) >> 1
    return x, y, face


def hpd2ring(nside: int, x, y, f):
    """(x, y, face) → RING pixel, branch-free over the three regions."""
    nside = int(nside)
    x = jnp.asarray(x, _I)
    y = jnp.asarray(y, _I)
    f = jnp.asarray(f, _I)
    jrll = jnp.asarray(_JRLL, _I)
    jpll = jnp.asarray(_JPLL, _I)
    nl4 = _I(4 * nside)
    jr = jrll[f] * nside - x - y - 1

    def bound(v):
        v = jnp.where(v < 1, v + nl4, v)
        return jnp.where(v > nl4, v - nl4, v)

    # north cap (jr < nside)
    jp_n = bound(_div_floor(jpll[f] * jr + x - y + 1, 2))
    pix_n = 2 * jr * (jr - 1) + jp_n - 1

    # south cap (jr > 3*nside)
    jri = nl4 - jr
    jp_s = bound(_div_floor(jpll[f] * jri + x - y + 1, 2))
    pix_s = 12 * nside * nside - 2 * (jri + 1) * jri + jp_s - 1

    # equatorial
    jp_e = bound(_div_floor(jpll[f] * nside + x - y + 1 + ((jr - nside) & 1), 2))
    pix_e = 2 * nside * (nside - 1) + (jr - nside) * nl4 + jp_e - 1

    return jnp.where(
        jr < nside, pix_n, jnp.where(jr > 3 * nside, pix_s, pix_e)
    )


def nest2ring(nside: int, pix):
    """NEST → RING pixel index (device-side, batched)."""
    if nside & (nside - 1):
        raise ValueError("NEST requires a power-of-two nside")
    return hpd2ring(nside, *nest2hpd(nside, pix))


def ring2nest(nside: int, pix):
    """RING → NEST pixel index (device-side, batched)."""
    if nside & (nside - 1):
        raise ValueError("NEST requires a power-of-two nside")
    return hpd2nest(nside, *ring2hpd(nside, pix))


def neighbors(nside: int, pix, nest: bool = False):
    """The 8 neighbors of each pixel, shape ``(..., 8)``; −1 marks the
    missing neighbor at the 8 face-corner singularities.

    Fully vectorized: the cross-face case formulas run for every pixel
    and are `where`-selected against the interior fast path — uniform
    control flow instead of the reference's per-pixel ``lax.cond``.
    """
    nside = int(nside)
    if nest and (nside & (nside - 1)):
        raise ValueError("NEST requires a power-of-two nside")
    pix = jnp.asarray(pix, _I)
    x, y, f = nest2hpd(nside, pix) if nest else ring2hpd(nside, pix)
    to_pix = hpd2nest if nest else hpd2ring

    xoff = jnp.asarray(_NB_XOFFSET, _I)
    yoff = jnp.asarray(_NB_YOFFSET, _I)
    facearray = jnp.asarray(_NB_FACEARRAY, _I)
    swaparray = jnp.asarray(_NB_SWAPARRAY, _I)

    xx = x[..., None] + xoff
    yy = y[..., None] + yoff

    # cross-face bounding: which of the 9 adjacency sectors the offset
    # lands in (4 = same face)
    cx = 2 * (xx < 0) + (xx >= nside)  # 0 inside, 1 over, 2 under
    cy = 2 * (yy < 0) + (yy >= nside)
    xx_b = jnp.where(cx == 1, xx - nside, jnp.where(cx == 2, xx + nside, xx))
    yy_b = jnp.where(cy == 1, yy - nside, jnp.where(cy == 2, yy + nside, yy))
    nbnum = 4 + jnp.where(cx == 1, 1, jnp.where(cx == 2, -1, 0)) + 3 * jnp.where(
        cy == 1, 1, jnp.where(cy == 2, -1, 0)
    )
    fnew = facearray[nbnum, f[..., None]]
    valid = fnew >= 0
    fsafe = jnp.maximum(fnew, 0)

    bits = swaparray[nbnum, f[..., None] >> 2]
    xs = jnp.where(bits & 1, nside - xx_b - 1, xx_b)
    ys = jnp.where(bits & 2, nside - yy_b - 1, yy_b)
    swap = (bits & 4).astype(bool)
    xf = jnp.where(swap, ys, xs)
    yf = jnp.where(swap, xs, ys)
    cross = to_pix(nside, xf, yf, fsafe)

    interior = to_pix(nside, jnp.clip(xx, 0, nside - 1), jnp.clip(yy, 0, nside - 1), f[..., None])
    inside = (cx == 0) & (cy == 0)
    return jnp.where(inside, interior, jnp.where(valid, cross, -1))
