"""Consistency checks for models, linear maps, and likelihoods.

The JAX-native analogues of the reference's operator test harness
(``nifty/cl/extra.py:42,131``): adjointness of ``jax.linear_transpose``
against explicit inner products, Jacobian (jvp/vjp) agreement with
finite differences, and the likelihood metric identities
``metric ≡ lsm ∘ rsm``.  These are what the test-suite sweeps over every
model/likelihood family instead of golden values.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax import numpy as jnp
from jax import random

from .likelihood import Likelihood
from .utils.tree import random_like, vdot

from contextlib import contextmanager

__all__ = [
    "check_no_host_transfers",
    "no_host_transfers",
    "assert_allclose",
    "check_linear_model",
    "check_model_jacobian",
    "check_likelihood_metrics",
]


def assert_allclose(a, b, *, rtol=1e-7, atol=0.0):
    la, sa = jax.tree_util.tree_flatten(a)
    lb, sb = jax.tree_util.tree_flatten(b)
    if sa != sb:
        raise AssertionError(f"tree structures differ: {sa} vs {sb}")
    for x, y in zip(la, lb):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), rtol=rtol, atol=atol
        )


def check_linear_model(
    f: Callable,
    domain,
    key,
    *,
    rtol=1e-6,
    atol=0.0,
):
    """Verify `f` is linear and its transpose is its adjoint:
    ⟨f(x), y⟩ == ⟨x, fᵀ(y)⟩ and f(αx₁+x₂) == αf(x₁)+f(x₂)."""
    k1, k2, k3 = random.split(key, 3)
    x1 = random_like(k1, domain)
    x2 = random_like(k2, domain)

    # linearity
    alpha = 1.7
    lhs = f(
        jax.tree_util.tree_map(lambda a, b: alpha * a + b, x1, x2)
    )
    rhs = jax.tree_util.tree_map(
        lambda a, b: alpha * a + b, f(x1), f(x2)
    )
    assert_allclose(lhs, rhs, rtol=rtol, atol=atol)

    # adjointness via linear_transpose
    y = random_like(k3, jax.eval_shape(f, x1))
    ft = jax.linear_transpose(f, x1)
    lhs_ip = vdot(y, f(x1))
    rhs_ip = vdot(ft(y)[0], x1)
    np.testing.assert_allclose(
        np.asarray(lhs_ip), np.asarray(rhs_ip), rtol=rtol, atol=atol
    )


def check_model_jacobian(
    model: Callable,
    pos,
    key,
    *,
    step=1e-4,
    rtol=1e-4,
    atol=1e-6,
):
    """Verify jvp against central finite differences along a random
    tangent, and ⟨J t, c⟩ == ⟨t, Jᵀ c⟩ for a random cotangent."""
    k1, k2 = random.split(key)
    tangent = random_like(k1, pos)

    _, jvp_val = jax.jvp(model, (pos,), (tangent,))
    p_plus = jax.tree_util.tree_map(lambda p, t: p + step * t, pos, tangent)
    p_minus = jax.tree_util.tree_map(lambda p, t: p - step * t, pos, tangent)
    fd = jax.tree_util.tree_map(
        lambda a, b: (a - b) / (2 * step), model(p_plus), model(p_minus)
    )
    assert_allclose(jvp_val, fd, rtol=rtol, atol=atol)

    out, vjp_fn = jax.vjp(model, pos)
    cotangent = random_like(k2, out)
    lhs = vdot(cotangent, jvp_val)
    rhs = vdot(vjp_fn(cotangent)[0], tangent)
    np.testing.assert_allclose(
        np.asarray(lhs), np.asarray(rhs), rtol=1e-6, atol=1e-9
    )


def check_likelihood_metrics(lh: Likelihood, pos, key, *, rtol=1e-6, atol=1e-9):
    """Verify the likelihood metric identities at `pos`:
    ``metric(t) == lsm(rsm(t))`` and symmetry ⟨t₁, M t₂⟩ == ⟨M t₁, t₂⟩."""
    k1, k2 = random.split(key)
    t1 = random_like(k1, pos)
    t2 = random_like(k2, pos)

    met = lh.metric(pos, t1)
    via_sqrt = lh.left_sqrt_metric(pos, lh.right_sqrt_metric(pos, t1))
    assert_allclose(met, via_sqrt, rtol=rtol, atol=atol)

    lhs = vdot(t2, lh.metric(pos, t1))
    rhs = vdot(lh.metric(pos, t2), t1)
    np.testing.assert_allclose(
        np.asarray(lhs), np.asarray(rhs), rtol=rtol, atol=atol
    )


@contextmanager
def no_host_transfers(level: str = "disallow"):
    """Sanitizer context: fail (or log) on implicit host↔device transfers.

    The analogue of the reference's device-copy guards
    (``nifty/cl/any_array.py:48`` `assert_no_device_copies` and the
    ``fail_on_device_copy`` config flag): inside the context, any
    implicit transfer — a numpy coercion of a device array, an implicit
    host-constant upload inside dispatch — raises (``"disallow"``) or
    logs (``"log"``).  Explicit ``jax.device_put``/``np.asarray`` remain
    allowed with ``"disallow"``; use ``"disallow_explicit"`` to forbid
    those too.

    Usage::

        with no_host_transfers():
            samples, state = optimize_kl(...)
    """
    allowed = {"allow", "log", "disallow", "log_explicit", "disallow_explicit"}
    if level not in allowed:
        raise ValueError(f"level must be one of {sorted(allowed)}")
    with jax.transfer_guard(level):
        yield


def check_no_host_transfers(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :func:`no_host_transfers` and
    block on the result — a one-call purity check for jitted pipelines."""
    with no_host_transfers():
        out = fn(*args, **kwargs)
        return jax.block_until_ready(out)
