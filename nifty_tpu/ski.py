"""Structured kernel interpolation (KISS-GP) covariance models.

GPs at arbitrary sampling points via interpolation from a regular grid
of inducing points: ``C ≈ W K_grid Wᵀ`` with `W` a sparse multilinear
interpolation matrix (BCOO gather/scatter) and the grid
covariance applied either spectrally (FFT-diagonal, :class:`HarmonicSKI`)
or as a Toeplitz matmul via circulant embedding (:class:`ToeplitzSKI`).

Behavioral parity with ``nifty/re/structured_kernel_interpolation.py``
(``HarmonicSKI:121``, ``ToeplitzSKI:320``, ``matmul_toeplitz:14``,
``interp_mat:60``); independent implementation.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import jax
import numpy as np
from jax import numpy as jnp
from jax.experimental.sparse import BCOO

from .models.correlated_field import get_fourier_mode_distributor
from .ops.fft import hartley

__all__ = ["matmul_toeplitz", "interp_mat", "HarmonicSKI", "ToeplitzSKI"]


def matmul_toeplitz(c, x):
    """Multiply the (symmetric-by-conjugation) Toeplitz matrix with first
    column `c` onto `x` via circulant embedding + FFT."""
    c = jnp.ravel(c)
    n = c.shape[0]
    x_shp = x.shape
    if x.shape[0] != n or x.ndim > 2:
        raise ValueError("invalid matrix product dimensions")
    x2 = x.reshape(n, -1)
    r = jnp.conj(c)
    emb = jnp.concatenate([c, r[-1:0:-1]])
    p = 2 * n - 1
    cmplx = jnp.iscomplexobj(emb) or jnp.iscomplexobj(x2)
    if cmplx:
        prod = jnp.fft.ifft(
            jnp.fft.fft(emb)[:, None] * jnp.fft.fft(x2, n=p, axis=0), axis=0
        )
    else:
        prod = jnp.fft.irfft(
            jnp.fft.rfft(emb)[:, None] * jnp.fft.rfft(x2, n=p, axis=0),
            n=p,
            axis=0,
        )
    out = prod[:n]
    return out.reshape(x_shp) if x.ndim == 1 else out


def interp_mat(
    grid_shape,
    grid_bounds,
    sampling_points,
    *,
    distances=None,
) -> BCOO:
    """Sparse multilinear interpolation matrix from a regular grid (the
    inducing points) to arbitrary `sampling_points` of shape
    ``(ndim, n_points)``; returns an ``(n_points, prod(grid_shape))``
    BCOO."""
    sampling_points = np.asarray(sampling_points)
    if sampling_points.ndim != 2:
        raise ValueError("sampling_points must be (ndim, n_points)")
    ndim, n_points = sampling_points.shape
    if (distances is None) == (grid_bounds is None):
        raise ValueError("pass exactly one of grid_bounds / distances")
    if grid_bounds is not None:
        grid_bounds = np.asarray(grid_bounds, dtype=float)
        offset = grid_bounds[:, 0]
        distances = (grid_bounds[:, 1] - grid_bounds[:, 0]) / np.asarray(
            grid_shape
        )
    else:
        offset = np.zeros(ndim)
        distances = np.broadcast_to(np.asarray(distances, float), (ndim,))

    rel = (sampling_points - offset[:, None]) / distances[:, None]
    frac, base = np.modf(rel)
    base = base.astype(np.int64)

    corners = np.stack(
        np.meshgrid(*([np.arange(2)] * ndim), indexing="ij"), axis=0
    ).reshape(ndim, -1)  # (ndim, 2^ndim)
    n_c = corners.shape[1]
    weights = np.empty((n_c, n_points))
    cols = np.empty((n_c, n_points), dtype=np.int64)
    for i in range(n_c):
        w = np.prod(np.abs(1.0 - corners[:, i : i + 1] - frac), axis=0)
        idx = np.clip(
            base + corners[:, i : i + 1],
            0,
            (np.asarray(grid_shape) - 1)[:, None],
        )
        weights[i] = w
        cols[i] = np.ravel_multi_index(idx, grid_shape)
    rows = np.broadcast_to(np.arange(n_points), (n_c, n_points))
    indices = np.stack([rows.ravel(), cols.ravel()], axis=1)
    mat = BCOO(
        (jnp.asarray(weights.ravel()), jnp.asarray(indices)),
        shape=(n_points, int(np.prod(grid_shape))),
    )
    return mat.sort_indices()


def _parse_jitter(jitter, dtype):
    if jitter is True:
        return 1e-8 if np.dtype(dtype) == np.float64 else 1e-6
    if jitter is False:
        return None
    return jitter


class HarmonicSKI:
    """KISS-GP covariance with a spectrally represented (stationary)
    kernel: C = W Hᵀ diag(P) H Wᵀ (+ jitter)."""

    def __init__(
        self,
        grid_shape,
        grid_bounds,
        sampling_points,
        harmonic_kernel: Optional[Callable] = None,
        padding: float = 0.5,
        jitter=True,
    ):
        sampling_points = np.asarray(sampling_points)
        self.jitter = _parse_jitter(jitter, sampling_points.dtype)
        self.grid_unpadded_shape = tuple(int(s) for s in grid_shape)
        self.w = interp_mat(grid_shape, grid_bounds, sampling_points)
        gb = np.asarray(grid_bounds, dtype=float)
        dist_up = (gb[:, 1] - gb[:, 0]) / np.asarray(grid_shape)
        self.grid_unpadded_total_volume = float(
            np.prod(np.asarray(grid_shape) * dist_up)
        )

        if padding:
            pshape = tuple(
                int(np.ceil(s * (1.0 + padding))) for s in grid_shape
            )
        else:
            pshape = self.grid_unpadded_shape
        self.grid_shape = pshape
        self.grid_distances = dist_up  # spacing unchanged; domain enlarged
        self.grid_total_volume = float(
            np.prod(np.asarray(pshape) * dist_up)
        )
        self.subslice = tuple(slice(0, s) for s in self.grid_unpadded_shape)
        (
            self.power_distributor,
            self.unique_mode_lengths,
            _,
        ) = get_fourier_mode_distributor(self.grid_shape, self.grid_distances)
        self._harmonic_kernel = harmonic_kernel

    @property
    def harmonic_kernel(self) -> Callable:
        if self._harmonic_kernel is None:
            raise TypeError("no harmonic kernel set")
        return self._harmonic_kernel

    def power(self, harmonic_kernel=None):
        hk = self.harmonic_kernel if harmonic_kernel is None else harmonic_kernel
        power = hk(jnp.asarray(self.unique_mode_lengths))
        return power * (self.grid_total_volume / self.grid_unpadded_total_volume)

    def amplitude(self, harmonic_kernel=None):
        return jnp.sqrt(self.power(harmonic_kernel))

    def harmonic_transform(self, x):
        return hartley(x) / self.grid_total_volume

    def correlated_field(self, x, harmonic_kernel=None):
        """Sample-path model on the (unpadded) grid: colored excitations."""
        amp = self.amplitude(harmonic_kernel)
        f = self.harmonic_transform(amp[jnp.asarray(self.power_distributor)] * x)
        return f[self.subslice]

    def sandwich(self, x, harmonic_kernel=None):
        x_pad = jnp.zeros(self.grid_shape, x.dtype).at[self.subslice].set(x)
        swd = jax.ShapeDtypeStruct(self.grid_shape, x.dtype)
        ht_t = jax.linear_transpose(self.harmonic_transform, swd)
        power = self.power(harmonic_kernel)
        s = self.harmonic_transform(
            power[jnp.asarray(self.power_distributor)] * ht_t(x_pad)[0]
        )
        return s[self.subslice]

    def __call__(self, x, harmonic_kernel=None):
        """Apply the SKI covariance to data-space `x`."""
        jit = 0.0 if self.jitter is None else self.jitter * x
        g = (self.w.T @ x.ravel()).reshape(self.grid_unpadded_shape)
        g = self.sandwich(g, harmonic_kernel=harmonic_kernel)
        out = (self.w @ g.ravel()).reshape(x.shape)
        return out + jit

    def evaluate(self, harmonic_kernel=None):
        """Materialize the full covariance (testing only)."""
        n = self.w.shape[0]
        eye = jnp.eye(n)
        return jax.vmap(lambda e: self(e, harmonic_kernel=harmonic_kernel))(
            eye
        ).T


class ToeplitzSKI:
    """KISS-GP covariance with the grid kernel applied as an (implicitly
    embedded) Toeplitz matrix — for kernels given in position space."""

    def __init__(
        self,
        grid_shape,
        grid_bounds,
        sampling_points,
        kernel: Optional[Callable] = None,
        jitter=True,
    ):
        sampling_points = np.asarray(sampling_points)
        self.jitter = _parse_jitter(jitter, sampling_points.dtype)
        self.grid_shape = tuple(int(s) for s in grid_shape)
        gb = np.asarray(grid_bounds, dtype=float)
        self.grid_distances = (gb[:, 1] - gb[:, 0]) / np.asarray(grid_shape)
        mg = np.mgrid[tuple(slice(s) for s in self.grid_shape)].astype(float)
        mg *= self.grid_distances.reshape((-1,) + (1,) * len(self.grid_shape))
        self.grid_distances_to_zero = np.linalg.norm(mg, axis=0)
        self.w = interp_mat(grid_shape, grid_bounds, sampling_points)
        self._kernel = kernel

    @property
    def kernel(self) -> Callable:
        if self._kernel is None:
            raise TypeError("no kernel set")
        return self._kernel

    def __call__(self, x, kernel=None):
        kernel = self.kernel if kernel is None else kernel
        jit = 0.0 if self.jitter is None else self.jitter * x
        g = self.w.T @ x.ravel()
        cov_row = kernel(self.grid_distances_to_zero).ravel()
        g = matmul_toeplitz(cov_row, g)
        out = (self.w @ g).reshape(x.shape)
        return out + jit

    def evaluate(self, kernel=None):
        n = self.w.shape[0]
        eye = jnp.eye(n)
        return jax.vmap(lambda e: self(e, kernel=kernel))(eye).T
