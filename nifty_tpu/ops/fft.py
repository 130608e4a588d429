"""Harmonic transforms on regular grids.

The Hartley transform — the real-valued self-inverse workhorse of the
correlated field — is built from the real FFT: for real input,
H(x) = Re(F(x)) - Im(F(x)).  Using ``rfftn`` halves the FLOPs and
memory traffic relative to a complex ``fftn``, with the hermitian
symmetry reconstructed by reversals and index takes.

Reference behavior: ``nifty/re/correlated_field.py:24-30`` (which uses a
full complex fftn).
"""

from __future__ import annotations

from typing import Optional, Sequence

from jax import numpy as jnp

__all__ = ["hartley"]


def _hermitian_extend(ft_half, shape, axes):
    """Reconstruct the full FFT array from the rfft half-spectrum."""
    last = axes[-1]
    n = shape[last]
    n_half = ft_half.shape[last]
    if n_half == n:
        return ft_half
    # F[k] for the missing ks follows from hermitian symmetry:
    #   F[k_1,...,k_d] = conj(F[-k_1,...,-k_d])
    missing = jnp.conj(
        jnp.flip(
            ft_half.take(indices=jnp.arange(1, n - n_half + 1), axis=last), axis=last
        )
    )
    for ax in axes[:-1]:
        m = missing.shape[ax]
        idx = (-jnp.arange(m)) % m
        missing = missing.take(indices=idx, axis=ax)
    return jnp.concatenate([ft_half, missing], axis=last)


def hartley(x, axes: Optional[Sequence[int]] = None):
    """Hartley transform over `axes` (all axes by default).

    Real input is computed via rfftn + hermitian reconstruction, complex
    input via fftn.  Self-adjoint up to the grid volume: H(H(x)) = N·x.
    """
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if jnp.iscomplexobj(x):
        ft = jnp.fft.fftn(x, axes=axes)
        return ft.real - ft.imag
    ft_half = jnp.fft.rfftn(x, axes=axes)
    ft = _hermitian_extend(ft_half, x.shape, axes)
    return ft.real - ft.imag
