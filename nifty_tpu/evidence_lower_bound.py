"""Evidence lower bound (ELBO) estimation via on-device Lanczos spectra.

The ELBO of a (metric-)Gaussian posterior approximation decomposes into
the sample-averaged Hamiltonian plus the entropy of the approximation;
the entropy needs ``tr log M⁻¹`` of the Hamiltonian metric
``M = M_lh + 1``.  Only the eigenvalues larger than one (at most
``min(n_data, n_params)`` of them — the likelihood-informed directions)
contribute; the remainder is exactly one.

Where the reference shells out to scipy/ARPACK on the host
(``nifty/re/evidence_lower_bound.py:341``, ``_eigsh:125``), this
implementation runs a **batched, deflated Lanczos** entirely in XLA: the
metric-vector product is the jitted forward/adjoint of the model, the
full reorthogonalization and the deflation against previously found
eigenvectors are dense matmuls, and the small tridiagonal
eigenproblem is a batched ``eigh``.  The deflation basis is kept at a
static padded width so every batch reuses one compiled program.

Behavioral parity with ``nifty/re/evidence_lower_bound.py``; independent
implementation.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax import numpy as jnp
from jax import random
from jax.flatten_util import ravel_pytree

from .evi import Samples
from .likelihood import Likelihood, StandardHamiltonian
from .logger import logger
from .num.lanczos import lanczos_tridiag
from .utils.tree import ShapeWithDtype

__all__ = ["estimate_evidence_lower_bound"]


def _size(tree) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    out = 0
    for l in leaves:
        if isinstance(l, ShapeWithDtype):
            out += l.size
        else:
            out += np.prod(np.shape(l), dtype=int)
    return int(out)


def _ravel_metric(metric, position, metric_jit=True):
    """Flatten a pytree→pytree metric into a flat-array matvec."""
    flat0, unravel = ravel_pytree(position)

    def met(x):
        t = unravel(x)
        r = metric(position, t)
        return ravel_pytree(r)[0]

    met = jax.jit(met) if metric_jit else met
    return met, flat0.size, flat0.dtype


def _deflated_lanczos_batch(met, v0, basis, order):
    """One Lanczos run on the deflated operator P·M·P, P = 1 − V Vᵀ.

    `basis` has static shape (k_max, n); unfilled rows are zero, so the
    projection matmuls are no-ops for them.
    """

    def deflate(x):
        return x - basis.T @ (basis @ x)

    def mdef(x):
        return deflate(met(deflate(x)))

    v0 = deflate(v0)
    return lanczos_tridiag(mdef, v0, order=order)


_deflated_lanczos_batch_jit = jax.jit(
    _deflated_lanczos_batch, static_argnames=("order",)
)


def _eigsh_lanczos(
    met,
    metric_size,
    dtype,
    n_eigenvalues,
    tot_dofs,
    *,
    key,
    min_lh_eval=1e-3,
    n_batches=10,
    krylov_factor=4,
    early_stop=True,
    verbose=True,
    resume_eigenvalues=None,
    resume_eigenvectors=None,
):
    """Top-`n_eigenvalues` eigenpairs of the metric by batched deflated
    Lanczos with full reorthogonalization."""
    if n_eigenvalues > tot_dofs:
        raise ValueError(
            "number of requested eigenvalues exceeds the relevant degrees of freedom"
        )
    batch_take = max(1, -(-n_eigenvalues // n_batches))
    order = int(min(metric_size, krylov_factor * batch_take + 10))

    eigenvalues = np.zeros((0,), dtype=np.float64)
    basis = jnp.zeros((n_eigenvalues, metric_size), dtype=dtype)
    n_found = 0
    if resume_eigenvectors is not None:
        ev = np.asarray(resume_eigenvectors)
        if ev.ndim != 2 or ev.shape[1] != metric_size:
            raise ValueError("resume_eigenvectors must be (k, metric_size)")
        el = np.asarray(resume_eigenvalues)
        order_idx = np.argsort(-el)
        el, ev = el[order_idx], ev[order_idx]
        el, ev = el[:n_eigenvalues], ev[:n_eigenvalues]
        n_found = el.size
        eigenvalues = el.astype(np.float64)
        basis = basis.at[:n_found].set(jnp.asarray(ev, dtype=dtype))
        if verbose:
            logger.info(f"ELBO: resuming with {n_found} precomputed eigenvalues")

    met_fn = jax.tree_util.Partial(met)

    while n_found < n_eigenvalues:
        if (
            early_stop
            and n_found > 0
            and abs(1.0 - float(np.min(eigenvalues))) < min_lh_eval
        ):
            if verbose:
                logger.info(
                    f"ELBO: early stop at {n_found} eigenvalues "
                    f"(min λ = {np.min(eigenvalues):.6f} ≈ 1)"
                )
            break
        key, sk = random.split(key)
        v0 = random.normal(sk, (metric_size,), dtype=dtype)
        tridiag, vecs = _deflated_lanczos_batch_jit(met_fn, v0, basis, order)
        tvals, tvecs = jnp.linalg.eigh(tridiag)
        # Ritz pairs, largest first
        tvals = tvals[::-1]
        tvecs = tvecs[:, ::-1]
        take = int(min(batch_take, n_eigenvalues - n_found))
        ritz_vals = np.asarray(tvals[:take], dtype=np.float64)
        ritz_vecs = np.asarray((vecs.T @ tvecs[:, :take]).T)  # (take, n)
        # deflated operator has spectrum {0} on the found subspace: accept
        # only values clearly above it (metric eigenvalues are ≥ 1)
        keep = ritz_vals > 0.5
        ritz_vals, ritz_vecs = ritz_vals[keep], ritz_vecs[keep]
        if ritz_vals.size == 0:
            if verbose:
                logger.info("ELBO: Lanczos batch returned no new eigenvalues; stop")
            break
        basis = basis.at[n_found : n_found + ritz_vals.size].set(
            jnp.asarray(ritz_vecs, dtype=dtype)
        )
        eigenvalues = np.concatenate([eigenvalues, ritz_vals])
        n_found += ritz_vals.size
        if verbose:
            logger.info(
                f"ELBO: {n_found}/{n_eigenvalues} eigenvalues, "
                f"current min λ = {np.min(eigenvalues):.6f}"
            )
        # re-orthonormalize the accumulated basis (cheap QR on device)
        q, _ = jnp.linalg.qr(basis[:n_found].T)
        basis = basis.at[:n_found].set(q.T)

    order_idx = np.argsort(-eigenvalues)
    eigenvalues = eigenvalues[order_idx]
    eigenvectors = np.asarray(basis[:n_found])[order_idx]
    return eigenvalues, eigenvectors


def estimate_evidence_lower_bound(
    likelihood: Optional[Likelihood],
    samples: Samples,
    n_eigenvalues: int,
    *,
    key=None,
    min_lh_eval: float = 1e-3,
    n_batches: int = 10,
    compute_all: bool = False,
    verbose: bool = True,
    output_directory: Optional[str] = None,
    save_eigensystem_prefix: str = "metric",
    resume_eigenvalues=None,
    resume_eigenvectors=None,
    metric_jit: bool = True,
):
    """Estimate the evidence lower bound (log-evidence lower bound) of a
    metric-Gaussian posterior approximation.

    Returns ``(elbo_samples, stats)`` where ``stats`` holds
    ``elbo_mean``/``elbo_up``/``elbo_lw`` and the truncation
    ``lower_error``. Reference semantics:
    ``nifty/re/evidence_lower_bound.py:341-578``.
    """
    if not isinstance(samples, Samples):
        raise TypeError("`samples` must be a Samples instance")
    if not isinstance(likelihood, Likelihood):
        raise TypeError("`likelihood` must be a Likelihood instance")
    key = random.PRNGKey(42) if key is None else key

    hamiltonian = StandardHamiltonian(likelihood)
    met, metric_size, dtype = _ravel_metric(
        hamiltonian.metric, samples.pos, metric_jit=metric_jit
    )
    n_data_points = _size(likelihood.lsm_tangents_shape)
    n_relevant_dofs = int(min(n_data_points, metric_size))
    if compute_all:
        n_eigenvalues = n_relevant_dofs

    if resume_eigenvectors is None and output_directory is not None:
        fn = os.path.join(output_directory, f"{save_eigensystem_prefix}_eigsys.npz")
        if os.path.isfile(fn):
            with np.load(fn) as f:
                resume_eigenvalues = f["eigenvalues"]
                resume_eigenvectors = f["eigenvectors"]
            if verbose:
                logger.info(f"ELBO: resuming eigensystem from {fn}")

    eigenvalues, eigenvectors = _eigsh_lanczos(
        met,
        metric_size,
        dtype,
        n_eigenvalues,
        tot_dofs=n_relevant_dofs,
        key=key,
        min_lh_eval=min_lh_eval,
        n_batches=n_batches,
        early_stop=not compute_all,
        verbose=verbose,
        resume_eigenvalues=resume_eigenvalues,
        resume_eigenvectors=resume_eigenvectors,
    )
    if output_directory is not None:
        os.makedirs(output_directory, exist_ok=True)
        fn = os.path.join(output_directory, f"{save_eigensystem_prefix}_eigsys.npz")
        np.savez(fn, eigenvalues=eigenvalues, eigenvectors=eigenvectors)

    if verbose:
        logger.info(
            f"ELBO: computed {eigenvalues.size} largest eigenvalues of "
            f"{n_relevant_dofs} relevant dofs (metric size {metric_size}); "
            "remaining eigenvalues are 1"
        )

    log_eigenvalues = np.log(np.maximum(eigenvalues, np.finfo(np.float64).tiny))
    tr_log_lat_cov = -0.5 * np.sum(log_eigenvalues)
    tr_log_lat_cov_lower = (
        0.5 * (n_relevant_dofs - log_eigenvalues.size) * np.min(log_eigenvalues)
        if log_eigenvalues.size
        else 0.0
    )
    posterior_contribution = tr_log_lat_cov + 0.5 * metric_size
    ham_j = jax.jit(hamiltonian) if metric_jit else hamiltonian
    elbo_samples = np.array([posterior_contribution - ham_j(s) for s in samples])

    stats = {"lower_error": tr_log_lat_cov_lower}
    elbo_mean = float(np.mean(elbo_samples))
    elbo_std = float(np.std(elbo_samples, ddof=1)) if elbo_samples.size > 1 else 0.0
    stats["elbo_mean"] = elbo_mean
    stats["elbo_up"] = elbo_mean + elbo_std
    stats["elbo_lw"] = elbo_mean - elbo_std - stats["lower_error"]
    if verbose:
        logger.info(
            f"ELBO mean: {elbo_mean:.4e} "
            f"(lower: {stats['elbo_lw']:.4e}, upper: {stats['elbo_up']:.4e})"
        )
    return elbo_samples, stats
