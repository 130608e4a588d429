"""Gauss-Markov processes (Wiener, integrated Wiener, Ornstein-Uhlenbeck).

Generators are expressed with cumulative sums / `associative_scan`-friendly
recurrences rather than sequential Python loops, so XLA can parallelize
them on the VPU.  Behavioral parity with ``nifty/re/gauss_markov.py``;
independent implementation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Union

import jax
import numpy as np
from jax import numpy as jnp
from jax.tree_util import tree_map

from ..model import Initializer, LazyModel, Model
from ..utils.tree import ShapeWithDtype, random_like
from .prior import LogNormalPrior, NormalPrior

__all__ = [
    "GaussMarkovProcess",
    "IntegratedWienerProcess",
    "OrnsteinUhlenbeckProcess",
    "WienerProcess",
    "discrete_gauss_markov_process",
    "integrated_wiener_process",
    "ornstein_uhlenbeck_process",
    "wiener_process",
]


def _isscalar(x):
    return jnp.ndim(x) == 0


def discrete_gauss_markov_process(xi, x0, drift, diffamp):
    """General discrete GMP: res_{i+1} = drift_i @ res_i + diffamp_i @ xi_i.

    Implemented as an associative scan over affine maps so the whole chain
    parallelizes (log-depth) instead of running a sequential loop.
    """
    if _isscalar(drift):
        drift = drift * jnp.ones((1, 1), dtype=jnp.result_type(xi))
    if _isscalar(diffamp):
        diffamp = diffamp * jnp.ones((1, 1), dtype=jnp.result_type(xi))

    n = xi.shape[0]
    dim = diffamp.shape[-1]
    innov = jnp.einsum(
        "...ij,...j->...i", diffamp, xi
    ) if diffamp.ndim == 3 else jnp.einsum("ij,nj->ni", diffamp, xi)
    drifts = (
        drift if drift.ndim == 3 else jnp.broadcast_to(drift, (n,) + drift.shape)
    )

    # Composition of affine maps (A2,b2)∘(A1,b1) = (A2A1, A2 b1 + b2) is
    # associative — scan it in parallel.
    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return jnp.einsum("...ij,...jk->...ik", a2, a1), (
            jnp.einsum("...ij,...j->...i", a2, b1) + b2
        )

    aa, bb = jax.lax.associative_scan(combine, (drifts, innov), axis=0)
    states = jnp.einsum("...ij,...j->...i", aa, x0) + bb
    return jnp.concatenate([x0[jnp.newaxis, ...], states], axis=0)


def scalar_gauss_markov_process(xi, x0, drift, diffamp):
    if not _isscalar(drift):
        drift = drift[:, jnp.newaxis, jnp.newaxis]
    if not _isscalar(diffamp):
        diffamp = diffamp[:, jnp.newaxis, jnp.newaxis]
    if _isscalar(x0):
        x0 = jnp.atleast_1d(x0)
    return discrete_gauss_markov_process(xi[:, jnp.newaxis], x0, drift, diffamp)[:, 0]


def wiener_process(xi, x0, sigma, dt):
    """Wiener process: x_{i+1} = x_i + sigma √dt ξ_i (a cumulative sum)."""
    amp = jnp.sqrt(dt) * sigma
    return jnp.cumsum(jnp.concatenate((jnp.atleast_1d(x0).ravel(), amp * xi)))


def integrated_wiener_process(xi, x0, sigma, dt, asperity=None):
    """(Generalized) integrated Wiener process via two chained cumsums.

    `xi` has shape (N, 2): one column drives the integrated component, the
    other the underlying Wiener process; `asperity` adds a rough WP
    component to the integrated coordinate.

    The two prefix sums run on *flat 1-D* arrays and the (N+1, 2) result
    is assembled at the end.
    """
    asperity = 0.0 if asperity is None else asperity
    dt = jnp.ones(xi.shape[0], dtype=jnp.result_type(xi)) * dt if _isscalar(dt) else dt
    amp = sigma * jnp.sqrt(dt)
    incr_y = amp * xi[:, 0] * jnp.sqrt(dt**2 / 12.0 + asperity)
    incr_s = amp * xi[:, 1]
    incr_y = incr_y + 0.5 * dt * incr_s
    s = jnp.cumsum(jnp.concatenate((x0[1:2], incr_s)))
    y_incr = jnp.concatenate((x0[0:1], incr_y + dt * s[:-1]))
    y = jnp.cumsum(y_incr)
    return jnp.stack((y, s), axis=-1)


def ornstein_uhlenbeck_process(xi, x0, sigma, gamma, dt):
    """OU process via the general (parallel-scan) GMP."""
    drift = jnp.exp(-gamma * dt)
    amp = sigma * jnp.sqrt(1.0 - drift**2)
    return scalar_gauss_markov_process(xi, x0, drift, amp)


class GaussMarkovProcess(Model):
    """Model wrapper: a GMP generator driven by named excitations, with
    hyper-parameters that may themselves be models
    (reference: ``nifty/re/gauss_markov.py:130``).

    ``dt``, ``x0`` and the hyper-models are dynamic pytree leaves: when a
    model embedding this process (e.g. a correlated field's spectrum
    deviations, whose ``dt`` has one entry per unique mode) is threaded
    through ``jit`` as an argument, these arrays are runtime parameters
    rather than inlined HLO constants.
    """

    x0: Any = dataclasses.field(metadata=dict(static=False), default=None)
    dt: Any = dataclasses.field(metadata=dict(static=False), default=None)
    kwargs: Any = dataclasses.field(metadata=dict(static=False), default=None)

    def __init__(
        self,
        process: Callable,
        x0,
        dt,
        name="xi",
        N_steps=None,
        **kwargs,
    ):
        if _isscalar(dt):
            if N_steps is None:
                raise ValueError("`N_steps` required when `dt` is scalar")
            dt = np.ones(N_steps) * dt
        x0_shape = jnp.shape(x0.target if isinstance(x0, LazyModel) else x0)
        shp = np.shape(dt) + x0_shape
        domain = {name: ShapeWithDtype(shp)}
        init = Initializer(
            tree_map(lambda p: partial(random_like, primals=p), domain)
        )
        if isinstance(x0, LazyModel):
            domain = {**domain, **x0.domain}
            init = init | x0.init
        for v in kwargs.values():
            if isinstance(v, LazyModel):
                domain = {**domain, **v.domain}
                init = init | v.init
        self.x0 = x0
        self.kwargs = kwargs
        self.name = name
        self.process = process
        self.dt = jnp.asarray(dt)
        super().__init__(domain=domain, init=init)

    def __call__(self, x):
        xi = x[self.name]
        x0 = self.x0(x) if isinstance(self.x0, LazyModel) else self.x0
        hyper = {
            k: (v(x) if isinstance(v, LazyModel) else v)
            for k, v in self.kwargs.items()
        }
        return self.process(xi=xi, x0=x0, dt=self.dt, **hyper)


def WienerProcess(x0, sigma, dt, name="wp", N_steps=None):
    """Wiener-process model; tuple hyper-parameters become priors."""
    if isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], name=name + "_x0")
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    return GaussMarkovProcess(
        wiener_process, x0, dt, name=name, N_steps=N_steps, sigma=sigma
    )


def IntegratedWienerProcess(x0, sigma, dt, name="iwp", asperity=None, N_steps=None):
    """Integrated-Wiener-process model — the power-spectrum deviation model
    of the correlated field."""
    if isinstance(x0, tuple):
        if jnp.shape(x0[0]) != (2,):
            raise ValueError(
                "x0 tuple must be (array(mean, mean), array(std, std))"
            )
        x0 = NormalPrior(x0[0], x0[1], shape=(2,), name=name + "_x0")
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    if isinstance(asperity, tuple):
        asperity = LogNormalPrior(asperity[0], asperity[1], name=name + "_asperity")
    return GaussMarkovProcess(
        integrated_wiener_process,
        x0,
        dt,
        name=name,
        N_steps=N_steps,
        sigma=sigma,
        asperity=asperity,
    )


def OrnsteinUhlenbeckProcess(sigma, gamma, dt, name="oup", x0=None, N_steps=None):
    """OU-process model; with no `x0`, draws it from the steady state."""
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    if isinstance(gamma, tuple):
        gamma = LogNormalPrior(gamma[0], gamma[1], name=name + "_gamma")
    if x0 is None:
        key = name + "_x0"

        def steady_state_x0(x):
            sig = sigma(x) if isinstance(sigma, LazyModel) else sigma
            sig0 = sig if _isscalar(sig) else sig[0]
            return x[key] * sig0

        domain = {key: ShapeWithDtype(())}
        init = Initializer(
            tree_map(lambda p: partial(random_like, primals=p), domain)
        )
        if isinstance(sigma, LazyModel):
            domain = {**domain, **sigma.domain}
            init = init | sigma.init
        x0 = Model(steady_state_x0, domain=domain, init=init)
    elif isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], name=name + "_x0")
    return GaussMarkovProcess(
        ornstein_uhlenbeck_process,
        x0,
        dt,
        name=name,
        N_steps=N_steps,
        sigma=sigma,
        gamma=gamma,
    )
