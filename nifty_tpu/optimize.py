"""Minimizers: Newton-CG (host-loop and fully-jittable) and a dispatcher.

The Newton-CG follows the reference's scheme
(``nifty/re/optimize.py:271-411``): the inner CG tolerance is set from the
energy scale (a forcing term), followed by a successive-halving line search
with a steepest-descent reset after 5 failed halvings.

:func:`static_newton_cg` runs the whole minimization inside
``lax.while_loop`` so a complete VI step (sampling + KL minimization) can
be one compiled XLA program with zero host round-trips.  Independent implementation.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Union

import jax
from jax import lax
from jax import numpy as jnp
from jax.tree_util import Partial, tree_map

from . import conjugate_gradient
from .logger import logger
from .utils.tree import norm as tree_norm
from .utils.tree import size, tree_axpy, vdot, where

__all__ = ["OptimizeResults", "minimize", "newton_cg", "optax_wrapper", "static_newton_cg", "trust_ncg"]


class OptimizeResults(NamedTuple):
    x: Any
    success: Any
    status: Any
    fun: Any
    jac: Any
    hess: Any = None
    hess_inv: Any = None
    nfev: Any = None
    njev: Any = None
    nhev: Any = None
    nit: Any = None


def _prepare_vag_hessp(fun, jac, hessp, fun_and_grad):
    if fun_and_grad is None:
        if fun is not None and jac is not None:
            fun_and_grad = lambda x: (fun(x), jac(x))
        elif fun is not None:
            fun_and_grad = jax.value_and_grad(fun)
        else:
            raise ValueError("no function (or value-and-grad) given")
    if hessp is None:
        if fun is None:
            raise NotImplementedError(
                "Newton-CG requires `hessp` (or `fun` to derive it from)"
            )
        # forward-over-reverse Hessian-vector product
        def hessp(primals, tangents):
            return jax.jvp(jax.grad(fun), (primals,), (tangents,))[1]

    return fun, fun_and_grad, hessp


def newton_cg(
    fun=None,
    x0=None,
    *,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=None,
    absdelta: Optional[float] = None,
    norm_ord=None,
    xtol: float = 1e-5,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    name: Optional[str] = None,
    cg: Callable = conjugate_gradient.cg,
    cg_kwargs: Optional[dict] = None,
    custom_gradnorm: Optional[Callable] = None,
) -> OptimizeResults:
    """Newton-CG with host-side control flow."""
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)
    cg_kwargs = {} if cg_kwargs is None else dict(cg_kwargs)
    cg_name = name + "CG" if name is not None else None
    gradnorm = (
        partial(tree_norm, ord=norm_ord) if custom_gradnorm is None else custom_gradnorm
    )

    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)

    pos = x0
    energy, g = fun_and_grad(pos)
    if jnp.isnan(energy):
        raise ValueError("energy is NaN")
    nfev, njev, nhev = 1, 1, 0
    status = -1
    i = 0
    for i in range(1, maxiter + 1):
        # CG forcing terms: the Newton model and the CG energy live on the
        # same scale, so the previous energy decrease bounds the useful CG
        # accuracy.
        if old_fval is not None and energy_reduction_factor:
            cg_absdelta = energy_reduction_factor * (old_fval - energy)
        else:
            cg_absdelta = None if absdelta is None else absdelta / 100.0
        mag_g = tree_norm(g, ord=cg_kwargs.get("norm_ord", 1))
        cg_resnorm = jnp.minimum(0.5, jnp.sqrt(mag_g)) * mag_g
        cg_res = cg(
            Partial(hessp, pos),
            g,
            **{
                "absdelta": cg_absdelta,
                "resnorm": cg_resnorm,
                "norm_ord": 1,
                "_raise_nonposdef": False,
                "name": cg_name,
                **cg_kwargs,
            },
        )
        nat_g, info = cg_res.x, cg_res.info
        nhev += int(cg_res.nfev)
        if info is not None and int(info) < 0:
            raise ValueError("conjugate gradient failed")

        # Successive-halving line search along the natural gradient with a
        # steepest-descent reset after 5 failed halvings.
        dd = nat_g
        scale = 1.0
        ls_reset = False
        for ls_it in range(9):
            new_pos = tree_axpy(-scale, dd, pos)
            new_energy, new_g = fun_and_grad(new_pos)
            nfev, njev = nfev + 1, njev + 1
            if new_energy <= energy:
                break
            scale /= 2.0
            if ls_it == 5:
                ls_reset = True
                gam = float(jnp.real(vdot(g, g)))
                curv = float(jnp.real(vdot(g, hessp(pos, g))))
                nhev += 1
                scale = 1.0
                dd = tree_map(lambda x: (gam / curv) * x, g)
        else:
            logger.warning(f"{name or 'N'}: WARNING: energy would increase; aborting")
            status = -1
            break

        energy_diff = energy - new_energy
        old_fval, energy, pos, g = energy, new_energy, new_pos, new_g
        descent_norm = scale * gradnorm(dd)
        if name is not None:
            logger.info(
                f"{name}: it {i} E {float(energy):+.6e} dE {float(energy_diff):.3e}"
                f" ls {ls_it}{' reset' if ls_reset else ''}"
            )
        if jnp.isnan(energy):
            raise ValueError("energy is NaN")
        if (
            absdelta is not None
            and 0.0 <= energy_diff < absdelta
            and ls_it < 2
            and i > miniter
        ):
            status = 0
            break
        if descent_norm <= xtol and i > miniter:
            status = 0
            break
    else:
        status = i
        logger.error(f"{name or 'N'}: iteration limit reached")
    return OptimizeResults(
        x=pos,
        success=True,
        status=status,
        fun=energy,
        jac=g,
        nit=i,
        nfev=nfev,
        njev=njev,
        nhev=nhev,
    )


def static_newton_cg(
    fun=None,
    x0=None,
    *,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=jnp.nan,
    absdelta: Optional[float] = None,
    norm_ord=None,
    xtol: float = 1e-5,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    name: Optional[str] = None,
    cg: Callable = conjugate_gradient.static_cg,
    cg_kwargs: Optional[dict] = None,
    custom_gradnorm: Optional[Callable] = None,
) -> OptimizeResults:
    """Newton-CG entirely in `lax` control flow (jit/vmap/shard-safe)."""
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)
    cg_kwargs = {} if cg_kwargs is None else dict(cg_kwargs)
    gradnorm = (
        partial(tree_norm, ord=norm_ord) if custom_gradnorm is None else custom_gradnorm
    )

    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)

    energy0, g0 = fun_and_grad(x0)
    state = {
        "pos": x0,
        "energy": energy0,
        "g": g0,
        "old_fval": jnp.asarray(
            jnp.nan if old_fval is None else old_fval, dtype=jnp.result_type(energy0)
        ),
        "nit": jnp.zeros((), jnp.int32),
        "status": jnp.asarray(-2, jnp.int32),  # -2 = keep iterating
    }

    def cont(s):
        return s["status"] < -1

    def step(s):
        pos, energy, g = s["pos"], s["energy"], s["g"]
        i = s["nit"] + 1
        have_old = ~jnp.isnan(s["old_fval"])
        # -inf disables the absdelta criterion inside the (traced) CG
        if energy_reduction_factor:
            cg_absdelta = jnp.where(
                have_old,
                energy_reduction_factor * (s["old_fval"] - energy),
                -jnp.inf if absdelta is None else absdelta / 100.0,
            )
        else:
            cg_absdelta = jnp.asarray(
                -jnp.inf if absdelta is None else absdelta / 100.0
            )
        mag_g = tree_norm(g, ord=cg_kwargs.get("norm_ord", 1))
        cg_resnorm = jnp.minimum(0.5, jnp.sqrt(mag_g)) * mag_g
        cg_res = cg(
            Partial(hessp, pos),
            g,
            **{
                "absdelta": cg_absdelta,
                "resnorm": cg_resnorm,
                "norm_ord": 1,
                "_raise_nonposdef": False,
                **cg_kwargs,
            },
        )
        nat_g = cg_res.x

        # line search: successive halving with a bounded while_loop
        def ls_cont(ls):
            return (~ls["accept"]) & (ls["it"] < 9)

        def ls_step(ls):
            it = ls["it"]
            dd, scale = ls["dd"], ls["scale"]
            # steepest-descent reset after 5 failed halvings
            def reset(_):
                gam = jnp.real(vdot(g, g))
                curv = jnp.real(vdot(g, hessp(pos, g)))
                return tree_map(lambda x: (gam / curv) * x, g), jnp.asarray(
                    1.0, dtype=scale.dtype
                )

            dd, scale = lax.cond(
                it == 6, reset, lambda _: (dd, scale), None
            )
            new_pos = tree_axpy(-scale, dd, pos)
            new_energy, new_g = fun_and_grad(new_pos)
            accept = new_energy <= energy
            return {
                "it": it + 1,
                "dd": dd,
                "scale": jnp.where(accept, scale, scale / 2.0),
                "accepted_scale": scale,
                "pos": new_pos,
                "energy": new_energy,
                "g": new_g,
                "accept": accept,
            }

        ls0 = {
            "it": jnp.zeros((), jnp.int32),
            "dd": nat_g,
            "scale": jnp.ones((), dtype=jnp.result_type(energy)),
            "accepted_scale": jnp.ones((), dtype=jnp.result_type(energy)),
            "pos": pos,
            "energy": energy,
            "g": g,
            "accept": jnp.asarray(False),
        }
        ls = lax.while_loop(ls_cont, ls_step, ls0)

        failed_ls = ~ls["accept"]
        new_pos = where(failed_ls, pos, ls["pos"])
        new_energy = jnp.where(failed_ls, energy, ls["energy"])
        new_g = where(failed_ls, g, ls["g"])
        energy_diff = energy - new_energy
        descent_norm = ls["accepted_scale"] * gradnorm(ls["dd"])

        status = s["status"]
        status = jnp.where(failed_ls, -1, status)
        if absdelta is not None:
            conv_abs = (
                (energy_diff >= 0.0)
                & (energy_diff < absdelta)
                & (ls["it"] <= 2)
                & (i > miniter)
            )
            status = jnp.where(conv_abs & (status == -2), 0, status)
        conv_x = (descent_norm <= xtol) & (i > miniter)
        status = jnp.where(conv_x & (status == -2), 0, status)
        status = jnp.where((i >= maxiter) & (status == -2), i, status)
        return {
            "pos": new_pos,
            "energy": new_energy,
            "g": new_g,
            "old_fval": energy,
            "nit": i,
            "status": status.astype(jnp.int32),
        }

    final = lax.while_loop(cont, step, state)
    return OptimizeResults(
        x=final["pos"],
        success=final["status"] >= 0,
        status=final["status"],
        fun=final["energy"],
        jac=final["g"],
        nit=final["nit"],
    )


def trust_ncg(
    fun=None,
    x0=None,
    *,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=jnp.nan,
    absdelta: Optional[float] = None,
    gtol: float = 1e-4,
    max_trust_radius: float = 1000.0,
    initial_trust_radius: float = 1.0,
    eta: float = 0.15,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    subproblem: Callable = conjugate_gradient.cg_steihaug,
    subproblem_kwargs: Optional[dict] = None,
    name: Optional[str] = None,
) -> OptimizeResults:
    """Trust-region Newton-CG (Nocedal & Wright alg. 4.1 with a Steihaug
    CG subproblem), entirely in ``lax`` control flow so a whole
    minimization is one compiled XLA program.  Convergence semantics match
    the reference (``nifty/re/optimize.py:672``); independent
    implementation."""
    maxiter = 200 if maxiter is None else maxiter
    if not 0 <= eta < 0.25:
        raise ValueError("invalid acceptance stringency `eta`")
    if gtol < 0.0 or max_trust_radius <= 0.0 or initial_trust_radius <= 0.0:
        raise ValueError("tolerances/radii must be positive")
    if initial_trust_radius >= max_trust_radius:
        raise ValueError("initial trust radius must be below the maximum")
    subproblem_kwargs = {} if subproblem_kwargs is None else dict(subproblem_kwargs)

    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)
    eps = 6.0 * jnp.finfo(jnp.result_type(*jax.tree_util.tree_leaves(x0))).eps

    f0, g0 = fun_and_grad(x0)
    norm_for_conv = partial(tree_norm, ord=subproblem_kwargs.get("norm_ord", 1))
    g0_mag = norm_for_conv(g0)
    state = {
        "pos": x0,
        "energy": f0,
        "g": g0,
        "g_mag": g0_mag,
        "old_fval": jnp.asarray(
            jnp.nan if old_fval is None else old_fval,
            dtype=jnp.result_type(f0),
        ),
        "trust_radius": jnp.asarray(initial_trust_radius, jnp.result_type(f0)),
        "nit": jnp.zeros((), jnp.int32),
        "nhev": jnp.zeros((), jnp.int32),
        # -2 = keep iterating; 0 = converged; 1 = iteration limit;
        # 2 = bad initial gradient / non-positive predicted reduction
        "status": jnp.asarray(
            -2 if maxiter > 0 else 1, jnp.int32
        ),
    }
    state["status"] = jnp.where(jnp.isfinite(g0_mag), state["status"], 2)

    def cont(s):
        return s["status"] < -1

    def step(s):
        pos, energy, g = s["pos"], s["energy"], s["g"]
        tr = s["trust_radius"]
        i = s["nit"] + 1

        have_old = ~jnp.isnan(s["old_fval"])
        if energy_reduction_factor:
            cg_absdelta = jnp.where(
                have_old,
                energy_reduction_factor * (s["old_fval"] - energy),
                -jnp.inf if absdelta is None else absdelta / 100.0,
            )
        else:
            cg_absdelta = jnp.asarray(
                -jnp.inf if absdelta is None else absdelta / 100.0
            )
        mag_g = s["g_mag"]
        cg_resnorm = jnp.minimum(0.5, jnp.sqrt(mag_g)) * mag_g
        sub = subproblem(
            Partial(hessp, pos),
            g,
            **{
                "trust_radius": tr,
                "cur_val": energy,
                "absdelta": cg_absdelta,
                "resnorm": cg_resnorm,
                "norm_ord": 1,
                **subproblem_kwargs,
            },
        )

        new_pos = tree_map(jnp.add, pos, sub.step)
        new_energy, new_g = fun_and_grad(new_pos)
        actual_red = energy - new_energy
        pred_red = energy - sub.pred_f
        rho = actual_red / pred_red

        tr_next = jnp.where(rho < 0.25, 0.25 * tr, tr)
        tr_next = jnp.where(
            (rho > 0.75) & sub.hits_boundary,
            jnp.minimum(2.0 * tr, max_trust_radius),
            tr_next,
        )

        accept = rho > eta
        new_g_mag = norm_for_conv(new_g)
        new_pos = where(accept, new_pos, pos)
        new_energy = jnp.where(accept, new_energy, energy)
        new_g = where(accept, new_g, g)
        new_g_mag = jnp.where(accept, new_g_mag, mag_g)

        energy_eps = eps * jnp.abs(new_energy)
        converged = (actual_red <= energy_eps) & (actual_red > -energy_eps)
        converged |= new_g_mag < gtol
        if absdelta is not None:
            converged |= accept & (actual_red > 0.0) & (actual_red < absdelta)

        status = s["status"]
        status = jnp.where(converged & (status == -2), 0, status)
        status = jnp.where((i >= maxiter) & (status == -2), 1, status)
        status = jnp.where(pred_red <= 0, 2, status)
        return {
            "pos": new_pos,
            "energy": new_energy,
            "g": new_g,
            "g_mag": new_g_mag,
            "old_fval": energy,
            "trust_radius": tr_next,
            "nit": i,
            "nhev": s["nhev"] + sub.nhev,
            "status": status.astype(jnp.int32),
        }

    final = lax.while_loop(cont, step, state)
    return OptimizeResults(
        x=final["pos"],
        success=final["status"] == 0,
        status=final["status"],
        fun=final["energy"],
        jac=final["g"],
        nit=final["nit"],
        nhev=final["nhev"],
    )


def optax_wrapper(
    fun=None,
    x0=None,
    *,
    optimizer=None,
    maxiter: Optional[int] = None,
    miniter: Optional[int] = None,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    name: Optional[str] = None,
    xtol: float = 1e-5,
) -> OptimizeResults:
    """Minimize with any optax optimizer (e.g. ``optax.adam``,
    ``optax.lbfgs``) inside one ``lax.while_loop`` — the bridge the
    reference provides at ``nifty/re/optimize.py:157``.  For L-BFGS the
    value/grad are threaded through optax's cached state so its own line
    search reuses evaluations."""
    import optax

    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)
    if optimizer is None:
        raise ValueError("`optimizer` (an optax GradientTransformation) is required")

    if fun_and_grad is None:
        if fun is not None and jac is not None:
            fun_and_grad = lambda x: (fun(x), jac(x))
        elif fun is not None:
            fun_and_grad = jax.value_and_grad(fun)
        else:
            raise ValueError("no function (or value-and-grad) given")
    fun_and_grad_plain = fun_and_grad

    is_lbfgs = type(optimizer).__name__.lower() == "lbfgs" or (
        hasattr(optax, "lbfgs") and getattr(optimizer, "_nifty_is_lbfgs", False)
    )
    use_state_vag = fun is not None and hasattr(optax, "value_and_grad_from_state")
    if use_state_vag:
        try:
            vag_state = optax.value_and_grad_from_state(fun)
        except Exception:  # pragma: no cover - optax version dependent
            use_state_vag = False
    f0, g0 = fun_and_grad_plain(x0)

    opt_state = optimizer.init(x0)

    def vag(params, state):
        if use_state_vag:
            try:
                return vag_state(params, state=state)
            except Exception:  # state lacks the cache fields
                pass
        return fun_and_grad_plain(params)

    def cont(s):
        unconverged = s["descent_norm"] > xtol
        return (unconverged | (s["nit"] < miniter)) & (s["nit"] < maxiter)

    def step(s):
        params, state = s["params"], s["state"]
        value, grad = vag(params, state)
        kwargs = dict(value=value, grad=grad, value_fn=fun)
        try:
            updates, state = optimizer.update(grad, state, params, **kwargs)
        except TypeError:
            updates, state = optimizer.update(grad, state, params)
        params = optax.apply_updates(params, updates)
        return {
            "params": params,
            "state": state,
            "nit": s["nit"] + 1,
            "descent_norm": tree_norm(updates, ord=2),
            "value": value,
        }

    state = {
        "params": x0,
        "state": opt_state,
        "nit": jnp.zeros((), jnp.int32),
        "descent_norm": jnp.asarray(jnp.inf, jnp.result_type(f0)),
        "value": f0,
    }
    final = lax.while_loop(cont, step, state)
    value, grad = fun_and_grad_plain(final["params"])
    return OptimizeResults(
        x=final["params"],
        success=jnp.asarray(True),
        status=jnp.where(final["nit"] < maxiter, 0, 1),
        fun=value,
        jac=grad,
        nit=final["nit"],
    )


def minimize(
    fun: Optional[Callable],
    x0,
    *,
    method: str,
    tol: Optional[float] = None,
    options: Optional[dict] = None,
) -> OptimizeResults:
    """SciPy-style dispatcher (reference: ``nifty/re/optimize.py:863``)."""
    options = {} if options is None else dict(options)
    if tol is not None:
        if method.lower() in ("newton-cg", "newtoncg", "ncg"):
            options.setdefault("xtol", tol)
    m = method.lower().replace("_", "-")
    if m in ("newton-cg", "newtoncg", "ncg"):
        return newton_cg(fun, x0, **options)
    if m in ("static-newton-cg", "staticnewtoncg"):
        return static_newton_cg(fun, x0, **options)
    if m in ("trust-ncg", "trustncg"):
        if tol is not None:
            options.setdefault("gtol", tol)
        return trust_ncg(fun, x0, **options)
    if m in ("l-bfgs", "lbfgs"):
        import optax

        options.setdefault("optimizer", optax.lbfgs())
        if tol is not None:
            options.setdefault("xtol", tol)
        return optax_wrapper(fun, x0, **options)
    if m == "optax":
        return optax_wrapper(fun, x0, **options)
    raise ValueError(f"unknown method {method!r}")


# Backwards-compatible aliases mirroring the reference's private names used
# throughout its own calls (`optimize._newton_cg` etc.).
_newton_cg = newton_cg
_static_newton_cg = static_newton_cg
