"""Conjugate gradient on pytrees.

Two variants with identical convergence semantics:

* :func:`cg` — host-side loop; cheap per-iteration Python logic, lets the
  caller stop early.  Each matrix-vector product is still a jitted device
  computation.
* :func:`static_cg` — the device-resident variant: the whole solve is one
  ``lax.while_loop`` inside ``jit``; no host↔device synchronization per
  iteration.  When the operand tree is sharded over a mesh, the ``vdot``
  reductions lower to ``psum`` collectives, so the same code is
  the distributed CG.

Convergence criteria (absdelta on the CG energy, residual norm, miniter /
maxiter, curvature guards, periodic residual recomputation) mirror the
reference (``nifty/re/conjugate_gradient.py:77-215,217-450``); independent
implementation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
from jax import numpy as jnp
from jax import lax
from jax.tree_util import Partial, tree_map

from .logger import logger
from .utils.tree import norm as tree_norm
from .utils.tree import result_type, size, tree_axpy, vdot, where, zeros_like

__all__ = ["CGResults", "SteihaugResults", "cg", "cg_steihaug", "static_cg"]

N_RESET = 20  # recompute the residual exactly every N iterations


class CGResults(NamedTuple):
    x: Any
    nit: Any
    nfev: Any
    info: Any
    success: Any


def _cg_defaults(j, absdelta, resnorm, tol, atol, miniter, maxiter, norm_ord):
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * size(j)  # SciPy NewtonCG heuristic
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)
    if absdelta is None and resnorm is None:
        resnorm = jnp.maximum(tol * tree_norm(j, ord=norm_ord), atol)
    return absdelta, resnorm, miniter, maxiter, norm_ord


def cg(
    mat: Callable,
    j,
    x0=None,
    *,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    tol: float = 1e-5,
    atol: float = 0.0,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    name: Optional[str] = None,
    _raise_nonposdef: bool = True,
    **_ignored,
) -> CGResults:
    """Solve `mat(x) = j` for positive-definite `mat` with a host loop."""
    absdelta, resnorm, miniter, maxiter, norm_ord = _cg_defaults(
        j, absdelta, resnorm, tol, atol, miniter, maxiter, norm_ord
    )
    dtp = result_type(j)
    eps = 6.0 * jnp.finfo(dtp).eps
    tiny = 6.0 * jnp.finfo(dtp).tiny

    if x0 is None:
        pos = zeros_like(j)
        r = tree_map(jnp.negative, j)
        energy = 0.0
        nfev = 0
    else:
        pos = x0
        r = tree_map(jnp.subtract, mat(pos), j)
        energy = float(jnp.real(vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos)))
        nfev = 1
    d = r
    gamma_prev = float(jnp.real(vdot(r, r)))
    if gamma_prev == 0.0:
        return CGResults(x=pos, info=0, nit=0, nfev=nfev, success=True)

    info = -1
    i = 0
    for i in range(1, maxiter + 1):
        q = mat(d)
        nfev += 1
        curv = float(jnp.real(vdot(d, q)))
        if curv == 0.0:
            if _raise_nonposdef:
                raise ValueError(f"{name or 'CG'}: zero curvature")
            info = 0
            break
        if curv < 0.0:
            if _raise_nonposdef:
                raise ValueError(f"{name or 'CG'}: negative curvature")
            if i == 1:
                # fall back to a short gradient step along -j
                pos = tree_map(lambda x: (gamma_prev / (-curv)) * (-x), j)
            info = 0
            break
        alpha = gamma_prev / curv
        pos = tree_axpy(-alpha, d, pos)
        if i % N_RESET == 0:
            r = tree_map(jnp.subtract, mat(pos), j)
            nfev += 1
        else:
            r = tree_axpy(-alpha, q, r)
        gamma = float(jnp.real(vdot(r, r)))
        if 0.0 <= gamma <= tiny:
            info = 0
            break
        if resnorm is not None:
            rn = float(tree_norm(r, ord=norm_ord))
            if name is not None:
                logger.info(f"{name}: CG it {i} resnorm {rn:.3e}")
            if rn < resnorm and i >= miniter:
                info = 0
                break
        new_energy = float(
            jnp.real(vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos))
        )
        energy_diff = energy - new_energy
        if energy_diff < -eps * abs(new_energy):
            if _raise_nonposdef:
                raise ValueError(f"{name or 'CG'}: energy increased")
            info = i
            break
        if absdelta is not None and energy_diff < absdelta and i >= miniter:
            info = 0
            break
        energy = new_energy
        beta = max(0.0, gamma / gamma_prev)
        d = tree_axpy(beta, d, r)
        gamma_prev = gamma
    info = i if info == -1 else info
    return CGResults(x=pos, info=info, nit=i, nfev=nfev, success=info == 0)


def static_cg(
    mat: Callable,
    j,
    x0=None,
    *,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    tol: float = 1e-5,
    atol: float = 0.0,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    name: Optional[str] = None,
    _raise_nonposdef: bool = False,
    **_ignored,
) -> CGResults:
    """Fully-jittable CG: one `lax.while_loop`, no host synchronization.

    Negative/zero curvature and energy increases terminate the loop with
    the best iterate found; `info` encodes the termination cause (0 =
    converged, >0 = stopped at iteration `info`, -1 = failure when
    `_raise_nonposdef`).
    """
    absdelta, resnorm, miniter, maxiter, norm_ord = _cg_defaults(
        j, absdelta, resnorm, tol, atol, miniter, maxiter, norm_ord
    )
    dtp = result_type(j)
    eps = 6.0 * jnp.finfo(dtp).eps
    tiny = 6.0 * jnp.finfo(dtp).tiny

    if x0 is None:
        pos = zeros_like(j)
        r = tree_map(jnp.negative, j)
        energy = jnp.asarray(0.0, dtype=dtp)
    else:
        pos = x0
        r = tree_map(jnp.subtract, mat(pos), j)
        energy = jnp.real(vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos))

    state = {
        "pos": pos,
        "r": r,
        "d": r,
        "iteration": jnp.zeros((), jnp.int32),
        "gamma": jnp.real(vdot(r, r)),
        "energy": energy,
        "info": jnp.asarray(-2, jnp.int32),  # -2 = keep iterating
    }

    def cont(s):
        return s["info"] < -1

    def step(s):
        i = s["iteration"] + 1
        info = s["info"]
        q = mat(s["d"])
        curv = jnp.real(vdot(s["d"], q))
        gamma_prev = s["gamma"]
        alpha = gamma_prev / curv
        bad_curv = curv <= 0.0
        info = jnp.where(bad_curv, -1 if _raise_nonposdef else 0, info)
        alpha = jnp.where(bad_curv, 0.0, alpha)
        pos = tree_axpy(-alpha, s["d"], s["pos"])
        r = lax.cond(
            (i % N_RESET == 0) & (info < -1),
            lambda op: tree_map(jnp.subtract, mat(op[0]), j),
            lambda op: tree_axpy(-op[2], op[3], op[1]),
            (pos, s["r"], alpha, q),
        )
        gamma = jnp.real(vdot(r, r))
        info = jnp.where((gamma <= tiny) & (info != -1), 0, info)
        if resnorm is not None:
            rn = tree_norm(r, ord=norm_ord)
            info = jnp.where((rn < resnorm) & (i >= miniter) & (info != -1), 0, info)
        energy = jnp.real(vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos))
        energy_diff = s["energy"] - energy
        info = jnp.where(
            energy_diff < -eps * jnp.abs(energy),
            -1 if _raise_nonposdef else i.astype(jnp.int32),
            info,
        )
        if absdelta is not None:
            info = jnp.where(
                (energy_diff < absdelta) & (i >= miniter) & (info != -1), 0, info
            )
        info = jnp.where((i >= maxiter) & (info != -1), i.astype(jnp.int32), info)
        d = tree_axpy(jnp.maximum(0.0, gamma / gamma_prev), s["d"], r)
        return {
            "pos": pos,
            "r": r,
            "d": d,
            "iteration": i,
            "gamma": gamma,
            "energy": energy,
            "info": info.astype(jnp.int32),
        }

    zero_j = state["gamma"] == 0.0
    state["info"] = jnp.where(zero_j, 0, state["info"]).astype(jnp.int32)
    final = lax.while_loop(cont, step, state)
    return CGResults(
        x=final["pos"],
        info=final["info"],
        nit=final["iteration"],
        nfev=final["iteration"],
        success=final["info"] == 0,
    )


# --- trust-region (Steihaug) CG ----------------------------------------------


class SteihaugResults(NamedTuple):
    step: Any
    hits_boundary: Any
    pred_f: Any
    nit: Any
    nhev: Any
    success: Any


def _tr_boundary_roots(z, d, trust_radius):
    """Both roots of ‖z + t·d‖₂ = Δ, numerically stable (smaller first)."""
    a = jnp.real(vdot(d, d))
    b = 2.0 * jnp.real(vdot(z, d))
    c = jnp.real(vdot(z, z)) - trust_radius**2
    disc = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
    # avoid catastrophic cancellation: compute the large-|.| root first
    aux = b + jnp.copysign(disc, b)
    ta = -aux / (2.0 * a)
    tb = -2.0 * c / aux
    return jnp.minimum(ta, tb), jnp.maximum(ta, tb)


def cg_steihaug(
    mat: Callable,
    j,
    *,
    trust_radius,
    cur_val=0.0,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    name: Optional[str] = None,
) -> SteihaugResults:
    """CG solution of the trust-region subproblem (Nocedal & Wright alg.
    7.2): minimize the local quadratic model m(p) = f + ⟨g,p⟩ + ½⟨p,B p⟩
    subject to ‖p‖ ≤ Δ, requiring only Hessian-vector products.

    Fully `lax`-native (one ``while_loop``), so it jits/shards like
    :func:`static_cg`; under a field-sharded tree the vdots reduce with
    psum collectives.  One Hessian-vector product per iteration and none
    at exit: boundary/interior model values come from the CG invariant
    r = g + Bz.  Matches the semantics of the reference
    (``nifty/re/conjugate_gradient.py:453``); independent implementation.
    Note the sign convention: `j` is the *gradient* g, and the returned
    step already points downhill (no final negation required).
    """
    g = j
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * size(g)
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)
    eps = 6.0 * jnp.finfo(result_type(g)).eps

    z0 = zeros_like(g)
    zero = jnp.zeros((), result_type(g))
    state = {
        "z": z0,
        "r": g,
        "d": tree_map(jnp.negative, g),
        "step": z0,
        # model value m(z) - f of the current iterate / of the returned step
        "energy": zero,
        "pred": zero,
        "hits_boundary": jnp.asarray(False),
        "done": jnp.asarray(bool(maxiter == 0)),
        "nit": jnp.zeros((), jnp.int32),
        "nhev": jnp.zeros((), jnp.int32),
    }

    def cont(s):
        return ~s["done"]

    def step(s):
        z, r, d = s["z"], s["r"], s["d"]
        i = s["nit"] + 1

        Bd = mat(d)
        dBd = jnp.real(vdot(d, Bd))
        rd = jnp.real(vdot(r, d))
        r2 = jnp.real(vdot(r, r))
        alpha = r2 / dBd
        z_next = tree_axpy(alpha, d, z)
        r_next = tree_axpy(alpha, Bd, r)
        r2_next = jnp.real(vdot(r_next, r_next))
        d_next = tree_axpy(r2_next / r2, d, tree_map(jnp.negative, r_next))

        # model value of the next iterate via the CG invariant r = g + Bz:
        # m(z) - f = ½⟨r + g, z⟩
        energy_next = jnp.real(
            vdot(tree_map(lambda a, b: (a + b) / 2.0, r_next, g), z_next)
        )
        energy_diff = s["energy"] - energy_next
        rn = (
            jnp.sqrt(r2_next)
            if norm_ord == 2
            else tree_norm(r_next, ord=norm_ord)
        )
        interior_conv = jnp.asarray(i >= maxiter)
        if resnorm is not None:
            interior_conv |= rn < resnorm
        if absdelta is not None:
            interior_conv |= (
                (energy_diff >= -eps * jnp.abs(energy_next))
                & (energy_diff < absdelta)
                & (i >= miniter)
            )

        zn = tree_norm(z_next, ord=2)
        neg_curv = dBd <= 0.0
        crosses = zn >= trust_radius

        # boundary intersections of z + t·d with the trust sphere; model
        # along the line: m(z + t d) = m(z) + t⟨r,d⟩ + ½t²⟨d,Bd⟩ — no
        # extra Hessian products needed
        ta, tb = _tr_boundary_roots(z, d, trust_radius)
        m_z = s["energy"]
        m_ta = m_z + ta * rd + 0.5 * ta * ta * dBd
        m_tb = m_z + tb * rd + 0.5 * tb * tb * dBd
        t_neg = jnp.where(m_ta < m_tb, ta, tb)
        m_neg = jnp.minimum(m_ta, m_tb)
        p_neg = tree_axpy(t_neg, d, z)
        p_cross = tree_axpy(tb, d, z)

        new_step = s["step"]
        new_pred = s["pred"]
        new_step = where(interior_conv, z_next, new_step)
        new_pred = jnp.where(interior_conv, energy_next, new_pred)
        new_step = where(crosses & ~neg_curv, p_cross, new_step)
        new_pred = jnp.where(crosses & ~neg_curv, m_tb, new_pred)
        new_step = where(neg_curv, p_neg, new_step)
        new_pred = jnp.where(neg_curv, m_neg, new_pred)
        done = neg_curv | crosses | interior_conv
        hits = neg_curv | crosses

        return {
            "z": z_next,
            "r": r_next,
            "d": d_next,
            "step": new_step,
            "energy": energy_next,
            "pred": new_pred,
            "hits_boundary": jnp.where(done, hits, s["hits_boundary"]),
            "done": done,
            "nit": i,
            "nhev": s["nhev"] + 1,
        }

    final = lax.while_loop(cont, step, state)
    return SteihaugResults(
        step=final["step"],
        hits_boundary=final["hits_boundary"],
        pred_f=cur_val + final["pred"],
        nit=final["nit"],
        nhev=final["nhev"],
        success=jnp.asarray(True),
    )
