"""Batteries-included adaptive NUTS sampling (native window adaptation).

Replaces the reference's blackjax dependency (``nifty/re/blackjax.py:65``)
with a native, fully-jittable implementation of Stan-style window
adaptation: dual-averaging step-size tuning toward a target acceptance
and a Welford estimator of the per-parameter posterior variance for the
diagonal (inverse) mass matrix, in a fast–slow–fast window schedule.

Warmup and sampling are each one ``lax.scan`` program, vmapped over
chains — on a device mesh, chains shard trivially over devices (shard the
leading chain axis of the keys/positions).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional, TypeVar, Union

import jax
import numpy as np
from jax import grad, lax
from jax import numpy as jnp
from jax import random
from jax import tree_util

from .evi import Samples
from .hmc import QP, generate_nuts_tree, leapfrog_step, sample_momentum_from_diagonal
from .likelihood import Likelihood
from .model import LazyModel
from .utils.tree import random_like, vdot

Q = TypeVar("Q")

__all__ = [
    "LogDensity",
    "nuts_sample",
    "blackjax_nuts",
    "get_sample_size_estimate",
]


class LogDensity(LazyModel):
    """Unnormalized posterior log-density in standardized coordinates:
    ``-lh(x) - ½‖x‖²`` (reference: ``nifty/re/blackjax.py:54``)."""

    likelihood: Likelihood = dataclasses.field(metadata=dict(static=False))

    def __init__(self, likelihood, /):
        self.likelihood = likelihood

    def __call__(self, x):
        return -(self.likelihood(x) + 0.5 * vdot(x, x).real)


# --- adaptation state --------------------------------------------------------


class _DualAveragingState(NamedTuple):
    log_step: jnp.ndarray
    log_step_avg: jnp.ndarray
    grad_avg: jnp.ndarray
    t: jnp.ndarray
    mu: jnp.ndarray


def _da_init(step_size):
    log_step = jnp.log(step_size)
    return _DualAveragingState(
        log_step=log_step,
        log_step_avg=jnp.asarray(0.0),
        grad_avg=jnp.asarray(0.0),
        t=jnp.asarray(0.0),
        mu=jnp.log(10.0) + log_step,
    )


def _da_update(state: _DualAveragingState, accept_prob, *, target=0.8,
               gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1.0
    g = target - accept_prob
    w = 1.0 / (t + t0)
    grad_avg = (1.0 - w) * state.grad_avg + w * g
    log_step = state.mu - jnp.sqrt(t) / gamma * grad_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return _DualAveragingState(log_step, log_step_avg, grad_avg, t, state.mu)


class _WelfordState(NamedTuple):
    count: jnp.ndarray
    mean: Q
    m2: Q


def _welford_init(proto):
    z = tree_util.tree_map(jnp.zeros_like, proto)
    return _WelfordState(jnp.asarray(0.0), z, tree_util.tree_map(jnp.zeros_like, proto))


def _welford_update(state: _WelfordState, x):
    count = state.count + 1.0
    delta = tree_util.tree_map(jnp.subtract, x, state.mean)
    mean = tree_util.tree_map(lambda m, d: m + d / count, state.mean, delta)
    delta2 = tree_util.tree_map(jnp.subtract, x, mean)
    m2 = tree_util.tree_map(
        lambda m2_, d, d2: m2_ + d * d2, state.m2, delta, delta2
    )
    return _WelfordState(count, mean, m2)


def _welford_variance(state: _WelfordState, *, regularize=True):
    n = state.count

    def var(m2):
        v = m2 / jnp.maximum(n - 1.0, 1.0)
        if regularize:
            # Stan's shrinkage toward unit variance for short windows
            v = (n / (n + 5.0)) * v + 1e-3 * (5.0 / (n + 5.0))
        return v

    return tree_util.tree_map(var, state.m2)


def _window_schedule(n_warmup, init_buffer=75, term_buffer=50, first_window=25):
    """Boolean mask marking the last step of each slow (mass-matrix)
    window — Stan's fast/slow/fast expanding schedule, computed statically."""
    n_warmup = int(n_warmup)
    if n_warmup < 20:
        return np.zeros(max(n_warmup, 0), dtype=bool)
    if init_buffer + term_buffer + first_window > n_warmup:
        scale = n_warmup / (init_buffer + term_buffer + first_window)
        init_buffer = int(init_buffer * scale)
        term_buffer = int(term_buffer * scale)
        first_window = max(1, n_warmup - init_buffer - term_buffer)
    mask = np.zeros(n_warmup, dtype=bool)
    pos = init_buffer
    w = first_window
    while pos + w < n_warmup - term_buffer:
        nxt = pos + w
        if nxt + 2 * w >= n_warmup - term_buffer:
            nxt = n_warmup - term_buffer  # absorb remainder into last window
        mask[nxt - 1] = True
        pos, w = nxt, 2 * w
    if not mask.any():
        mask[n_warmup - term_buffer - 1] = True
    return mask


# --- driver ------------------------------------------------------------------


def _nuts_transition(
    logdensity, key, position, step_size, inverse_mass_matrix, max_tree_depth,
    max_energy_difference,
):
    potential_energy = lambda q: -logdensity(q)  # noqa: E731
    kinetic_energy = lambda inv_m, p: vdot(  # noqa: E731
        inv_m, tree_util.tree_map(lambda x: x**2 / 2.0, p)
    )
    kinetic_energy_gradient = lambda inv_m, p: tree_util.tree_map(  # noqa: E731
        jnp.multiply, inv_m, p
    )
    stepper = partial(
        leapfrog_step, grad(potential_energy), kinetic_energy_gradient
    )
    k_mom, k_tree = random.split(key)
    mass_matrix_sqrt = tree_util.tree_map(
        lambda m: m ** (-0.5), inverse_mass_matrix
    )
    momentum = sample_momentum_from_diagonal(
        key=k_mom, mass_matrix_sqrt=mass_matrix_sqrt
    )
    tree = generate_nuts_tree(
        QP(position=position, momentum=momentum),
        k_tree,
        step_size,
        max_tree_depth,
        stepper,
        potential_energy,
        kinetic_energy,
        inverse_mass_matrix,
        max_energy_difference=max_energy_difference,
    )
    n_prop = jnp.maximum(1.0, jnp.exp2(tree.depth.astype(jnp.float32)) - 1.0)
    accept_prob = jnp.clip(tree.cumulative_acceptance / n_prop, 0.0, 1.0)
    return tree.proposal_candidate.position, accept_prob, tree.diverging, tree.depth


def nuts_sample(
    likelihood_or_logdensity,
    key,
    *,
    n_chains: int = 4,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    position_proto: Optional[Q] = None,
    initial_position: Optional[Q] = None,
    step_size: float = 0.5,
    max_tree_depth: int = 10,
    target_acceptance: float = 0.8,
    max_energy_difference: float = 1000.0,
    chain_map=jax.vmap,
) -> tuple:
    """Adaptive multi-chain NUTS.

    Accepts a :class:`Likelihood` (sampled in standardized coordinates,
    with the standard-normal prior added) or any callable log-density.
    Returns ``(samples, info)`` where `samples` is a
    :class:`~nifty_tpu.evi.Samples` with a leading ``(n_chains·n_samples)``
    axis and `info` carries acceptance/divergence/step-size diagnostics.
    """
    if isinstance(likelihood_or_logdensity, Likelihood):
        logdensity = LogDensity(likelihood_or_logdensity)
        if position_proto is None:
            position_proto = likelihood_or_logdensity.domain
    else:
        logdensity = likelihood_or_logdensity
        if position_proto is None and initial_position is None:
            raise ValueError(
                "position_proto or initial_position required for a bare log-density"
            )

    key, k_init = random.split(key)
    if initial_position is None:
        init_keys = random.split(k_init, n_chains)
        initial_position = jax.vmap(lambda k: random_like(k, position_proto))(
            init_keys
        )
    window_mask = jnp.asarray(_window_schedule(n_warmup))

    transition = partial(
        _nuts_transition,
        logdensity,
        max_tree_depth=max_tree_depth,
        max_energy_difference=max_energy_difference,
    )

    def warmup_one_chain(key, pos0):
        da = _da_init(jnp.asarray(step_size))
        inv_m = tree_util.tree_map(jnp.ones_like, pos0)
        wf = _welford_init(pos0)

        def step(carry, inp):
            key, pos, da, inv_m, wf = carry
            is_window_end = inp
            key, k_t = random.split(key)
            pos, acc, div, _ = transition(
                k_t, pos, jnp.exp(da.log_step), inv_m
            )
            da = _da_update(da, acc, target=target_acceptance)
            wf = _welford_update(wf, pos)

            def close_window(args):
                da, inv_m, wf = args
                inv_m = _welford_variance(wf)
                wf = _welford_init(pos)
                # restart step-size search at the averaged value
                da = _da_init(jnp.exp(da.log_step_avg))
                return da, inv_m, wf

            da, inv_m, wf = lax.cond(
                is_window_end, close_window, lambda a: a, (da, inv_m, wf)
            )
            return (key, pos, da, inv_m, wf), (acc, div)

        (key, pos, da, inv_m, _), (accs, divs) = lax.scan(
            step, (key, pos0, da, inv_m, wf), window_mask
        )
        eps = jnp.exp(da.log_step_avg)
        return pos, eps, inv_m, accs, divs

    def sample_one_chain(key, pos0, eps, inv_m):
        def step(carry, _):
            key, pos = carry
            key, k_t = random.split(key)
            pos, acc, div, depth = transition(k_t, pos, eps, inv_m)
            return (key, pos), (pos, acc, div, depth)

        (_, _), (poss, accs, divs, depths) = lax.scan(
            step, (key, pos0), None, length=n_samples
        )
        return poss, accs, divs, depths

    chain_keys = random.split(key, n_chains)
    wkeys = jax.vmap(lambda k: random.fold_in(k, 0))(chain_keys)
    skeys = jax.vmap(lambda k: random.fold_in(k, 1))(chain_keys)

    pos_w, eps, inv_m, w_accs, w_divs = chain_map(warmup_one_chain)(
        wkeys, initial_position
    )
    poss, accs, divs, depths = chain_map(sample_one_chain)(
        skeys, pos_w, eps, inv_m
    )

    flat = tree_util.tree_map(
        lambda x: x.reshape((-1,) + x.shape[2:]), poss
    )
    samples = Samples(pos=None, samples=flat)
    info = {
        "step_size": eps,
        "inverse_mass_matrix": inv_m,
        "acceptance": jnp.mean(accs, axis=-1),
        "divergences": jnp.sum(divs, axis=-1),
        "warmup_divergences": jnp.sum(w_divs, axis=-1),
        "tree_depths": depths,
        "chain_samples": poss,
    }
    return samples, info


def blackjax_nuts(
    likelihood,
    key,
    *,
    n_chains: int = 4,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    **kwargs,
):
    """API-compatible stand-in for the reference's blackjax bridge
    (``nifty/re/blackjax.py:65``).

    Uses the external ``blackjax`` window adaptation when the package is
    importable, the native :func:`nuts_sample` otherwise — identical
    return convention either way.
    """
    try:
        import blackjax  # noqa: F401
    except ImportError:
        return nuts_sample(
            likelihood,
            key,
            n_chains=n_chains,
            n_samples=n_samples,
            n_warmup=n_warmup,
            **kwargs,
        )
    import blackjax

    logdensity = LogDensity(likelihood)
    key, k_adapt, k_init = random.split(key, 3)
    pos0 = random_like(k_init, likelihood.domain)
    wa = blackjax.window_adaptation(
        blackjax.nuts, logdensity, target_acceptance_rate=0.8
    )
    (state, parameters), _ = wa.run(k_adapt, pos0, num_steps=n_warmup)
    kernel = blackjax.nuts(logdensity, **parameters).step

    def one_chain(k, state):
        def step(carry, k):
            state = carry
            state, info = kernel(k, state)
            return state, (state.position, info.acceptance_rate)

        keys = random.split(k, n_samples)
        _, (poss, accs) = lax.scan(step, state, keys)
        return poss, accs

    chain_keys = random.split(key, n_chains)
    states = jax.vmap(lambda _: state)(jnp.arange(n_chains))
    poss, accs = jax.vmap(one_chain)(chain_keys, states)
    flat = tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), poss)
    return Samples(pos=None, samples=flat), {"acceptance": accs.mean(axis=-1)}


def get_sample_size_estimate(samples, axis=0):
    """Crude effective-sample-size estimate from lag-1 autocorrelation,
    per leaf (reference: ``nifty/re/blackjax.py:17``)."""

    def ess(x):
        x = jnp.moveaxis(x, axis, 0)
        n = x.shape[0]
        xc = x - x.mean(axis=0, keepdims=True)
        num = jnp.sum(xc[1:] * xc[:-1], axis=0)
        den = jnp.sum(xc * xc, axis=0)
        rho1 = jnp.where(den > 0, num / den, 0.0)
        rho1 = jnp.clip(rho1, -0.99, 0.99)
        return n * (1.0 - rho1) / (1.0 + rho1)

    return tree_util.tree_map(ess, samples)
