"""Lanczos tridiagonalization and stochastic log-determinants.

Formulation: the full reorthogonalization of each Krylov vector
against the accumulated basis is expressed as two dense matmuls
(``V @ w`` then ``V.T @ coeff``) instead of a loop of rank-1 updates; the Krylov recurrence itself is a ``lax.fori_loop``
with static ``order`` so the whole decomposition is one XLA program.

Replaces scipy's ARPACK (used by the reference for ELBO spectra) and
mirrors the behavior of ``nifty/re/num/lanczos.py`` (lanczos_tridiag,
stochastic_logdet_from_lanczos, stochastic_lq_logdet); independent
implementation.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax import lax
from jax import numpy as jnp
from jax import random

__all__ = [
    "lanczos_tridiag",
    "stochastic_logdet_from_lanczos",
    "stochastic_lq_logdet",
]


def lanczos_tridiag(
    mat: Callable[[jnp.ndarray], jnp.ndarray],
    v: jnp.ndarray,
    *,
    order: int,
    tol: float = 1e-12,
):
    """Lanczos decomposition ``mat ≈ Vᵀ T V`` with full reorthogonalization.

    Parameters
    ----------
    mat : callable
        Symmetric (hermitian) matrix-vector product on flat arrays.
    v : jnp.ndarray
        Start vector (flat). Need not be normalized.
    order : int
        Krylov order; ``T`` is ``(order, order)``, the basis ``V`` is
        ``(order, n)``. Fixed shapes — breakdown (β≈0) pads with zeros
        instead of terminating, keeping the program jit-stable.

    Returns
    -------
    (tridiag, vecs) : (jnp.ndarray, jnp.ndarray)
        The tridiagonal matrix and the stacked Krylov basis.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    v = jnp.asarray(v)
    if v.ndim != 1:
        raise ValueError("lanczos_tridiag operates on flat arrays")
    n = v.shape[0]
    dtype = v.dtype

    tridiag = jnp.zeros((order, order), dtype=dtype)
    vecs = jnp.zeros((order, n), dtype=dtype)
    v0 = v / jnp.linalg.norm(v)
    vecs = vecs.at[0].set(v0)

    w = mat(v0)
    alpha = jnp.dot(w, v0)
    tridiag = tridiag.at[0, 0].set(alpha)
    if order == 1:
        return tridiag, vecs
    w = w - alpha * v0
    beta = jnp.linalg.norm(w)
    tridiag = tridiag.at[0, 1].set(beta).at[1, 0].set(beta)
    vecs = vecs.at[1].set(jnp.where(beta > tol, 1.0 / beta, 0.0) * w)

    def step(i, carry):
        tridiag, vecs, beta = carry
        q = vecs[i]
        q_prev = vecs[i - 1]
        w = mat(q) - beta * q_prev
        alpha = jnp.dot(w, q)
        tridiag = tridiag.at[i, i].set(alpha)
        w = w - alpha * q
        # full reorthogonalization as two matmuls against the whole
        # (zero-padded, hence harmless) basis
        coeff = vecs @ w  # (order,)
        w = w - vecs.T @ coeff
        beta = jnp.linalg.norm(w)
        tridiag = tridiag.at[i, i + 1].set(beta).at[i + 1, i].set(beta)
        vecs = vecs.at[i + 1].set(jnp.where(beta > tol, 1.0 / beta, 0.0) * w)
        return tridiag, vecs, beta

    if order > 2:
        tridiag, vecs, beta = lax.fori_loop(1, order - 1, step, (tridiag, vecs, beta))

    # last diagonal entry (no new basis vector)
    q = vecs[order - 1]
    q_prev = vecs[order - 2]
    w = mat(q) - beta * q_prev
    alpha = jnp.dot(w, q)
    tridiag = tridiag.at[order - 1, order - 1].set(alpha)
    return tridiag, vecs


def stochastic_logdet_from_lanczos(tridiag_stack: jnp.ndarray, matrix_shape0: int):
    """Stochastic-Lanczos-quadrature log-determinant from a stack of
    tridiagonal matrices (one per random probe).

    logdet ≈ n · mean_probes Σ_i (e₁ᵀu_i)² log λ_i with (λ, u) the
    eigensystem of each small tridiagonal matrix — evaluated with the
    batched on-device ``eigh``.
    """
    eig_vals, eig_vecs = jnp.linalg.eigh(tridiag_stack)
    tiny = jnp.finfo(eig_vals.dtype).tiny
    log_eig = jnp.log(jnp.maximum(eig_vals, tiny))
    # weight of the start vector e₁ in each Ritz vector
    w1 = eig_vecs[..., 0, :]
    per_probe = jnp.sum(w1 * w1 * log_eig, axis=-1)
    return matrix_shape0 * jnp.mean(per_probe)


def stochastic_lq_logdet(
    mat,
    order: int,
    n_samples: int,
    key,
    *,
    shape0=None,
    dtype=None,
):
    """Stochastic Lanczos quadrature estimate of ``log|det(mat)|``.

    `mat` may be a dense matrix or a flat-array matvec callable (pass
    ``shape0`` for the latter).
    """
    if callable(mat):
        if shape0 is None:
            raise ValueError("shape0 required for callable `mat`")
        matvec = mat
        n = int(shape0)
    else:
        mat = jnp.asarray(mat)
        n = mat.shape[0]
        matvec = lambda x: mat @ x  # noqa: E731
    dtype = jnp.float64 if dtype is None else dtype
    dtype = jnp.promote_types(dtype, jnp.float32)

    keys = random.split(key, n_samples)

    def probe_tridiag(k):
        v = random.rademacher(k, (n,), dtype=dtype)
        td, _ = lanczos_tridiag(matvec, v, order=order)
        return td

    tridiags = jax.vmap(probe_tridiag)(keys)
    return stochastic_logdet_from_lanczos(tridiags, n)
