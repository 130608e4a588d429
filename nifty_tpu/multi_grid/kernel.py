"""Iterative charted refinement (ICR) kernels, batched as matmuls.

A multi-grid GP sample is built coarse-to-fine: the base level is an
explicit Cholesky draw; every refinement step predicts the children of
each interior coarse cell from its stencil neighborhood and adds the
conditional fluctuation,

    fine_b = OLF_b · window_b + KER_b · ξ_b ,

with ``OLF = Σ_fc Σ_cc⁻¹`` and ``KER·KERᵀ = Σ_ff − Σ_fc Σ_cc⁻¹ Σ_cfᵀ``
derived from the covariance function on the stencil geometry (reference:
``nifty/re/multi_grid/kernel.py:270`` ``refinement_matrices``).

Layout decisions (vs the reference's per-index vmap):

- **Stencil windows are slice-stacks, not gathers** — the open-grid
  layout makes every window a shifted interior view, so window
  extraction is ``2·p+1``^ndim static slices concatenated on device.
- **Children scatter is a reshape/transpose**, never a scatter op.
- **Stencil matrices are deduplicated at construction** by tolerant
  uniqueness of their distance matrices.  Uniform charts collapse to a
  *single* stencil per level, turning the whole refinement into one
  ``(n_blocks, W) @ (W, C)`` matmul; product charts with a log axis
  keep one stencil per radial shell.
- The conditional square root uses a **jittered Cholesky** (batched,
  device-side) instead of an eigendecomposition — any factor of the
  conditional covariance is statistically equivalent.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax import numpy as jnp

from .grid import Grid

__all__ = ["ICRKernel", "apply_kernel"]


def _tolerant_unique_rows(mats: np.ndarray, rtol: float, atol: float):
    """Dedup a stack of matrices within tolerance; returns (unique stack,
    inverse index per input row)."""
    n = mats.shape[0]
    scale = max(np.abs(mats).max(), atol)
    key = np.round(mats / (rtol * scale + atol), 0).astype(np.int64)
    key = key.reshape(n, -1)
    _, uidx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    return mats[uidx], inv.ravel(), uidx


class _LevelLayout:
    """Static (numpy) refinement layout of one level.

    Stencils are deduplicated **per axis**: block positions along an axis
    whose (window + children) coordinate pattern is translation-invariant
    collapse to a single pattern, so nothing of size O(n_blocks) beyond
    two small index vectors is ever built — a uniform chart yields one
    stencil, a chart with one non-uniform (e.g. log-radial) axis yields
    one stencil per shell.
    """

    def __init__(self, grid: Grid, level: int, rtol: float, atol: float):
        self.level = level
        cshape = grid.shapes[level]
        fshape = grid.shapes[level + 1]
        pad = grid.padding
        splits = grid.splits
        ndim = grid.ndim
        self.block_shape = tuple(c - 2 * p for c, p in zip(cshape, pad))
        self.n_blocks = int(np.prod(self.block_shape))
        self.window_shape = tuple(2 * p + 1 for p in pad)
        self.w = int(np.prod(self.window_shape))
        self.c = int(np.prod(splits))
        self.cshape, self.fshape, self.pad, self.splits = (
            cshape,
            fshape,
            pad,
            splits,
        )

        glvl_c = grid.at(level)
        glvl_f = grid.at(level + 1)

        # --- per-axis coordinate patterns --------------------------------
        # For each axis d and block position b: the window coordinates
        # (w_d values) and child coordinates (s_d values) along that axis.
        axis_coords = []  # per axis: (B_d, w_d + s_d) float
        axis_inv = []  # per axis: None (uniform) or (B_d,) pattern id
        axis_n_unique = []
        for d in range(ndim):
            b = np.arange(self.block_shape[d])
            cw = (b[:, None] + pad[d]) + np.arange(-pad[d], pad[d] + 1)[None]
            cf = b[:, None] * splits[d] + np.arange(splits[d])[None]
            # coordinate along this axis only (index2coord is separable)
            idx_c = np.zeros((ndim, cw.shape[0], cw.shape[1]), dtype=int)
            idx_c[d] = cw
            xc = glvl_c.index2coord(idx_c)[d]
            idx_f = np.zeros((ndim, cf.shape[0], cf.shape[1]), dtype=int)
            idx_f[d] = cf
            xf = glvl_f.index2coord(idx_f)[d]
            coords_d = np.concatenate([xc, xf], axis=1)  # (B_d, w_d+s_d)
            axis_coords.append(coords_d)
            rel = coords_d - coords_d[:, :1]
            scale = max(np.abs(rel).max(), atol)
            key = np.round(rel / (rtol * scale + atol)).astype(np.int64)
            _, uidx, inv = np.unique(
                key, axis=0, return_index=True, return_inverse=True
            )
            if uidx.size == 1:
                axis_inv.append(None)
                axis_n_unique.append(1)
            else:
                axis_inv.append(inv.ravel())
                axis_n_unique.append(uidx.size)
        self.varying_axes = [d for d in range(ndim) if axis_inv[d] is not None]

        # --- unique stencil distance matrices ----------------------------
        # representative block position per unique combo; only the varying
        # axes enumerate, uniform axes pin to block 0
        combos = [
            np.arange(axis_n_unique[d]) if axis_inv[d] is not None else [0]
            for d in range(ndim)
        ]
        reps = []  # representative per-axis block positions
        for d in range(ndim):
            if axis_inv[d] is None:
                reps.append(np.zeros(1, dtype=int))
            else:
                first = np.zeros(axis_n_unique[d], dtype=int)
                for u in range(axis_n_unique[d]):
                    first[u] = int(np.argmax(axis_inv[d] == u))
                reps.append(first)
        mesh = np.meshgrid(*combos, indexing="ij")
        combo_ids = np.stack([m.ravel() for m in mesh], axis=0)  # (ndim, nu)
        n_unique = combo_ids.shape[1]

        # build (nu, w+c, w+c) distance matrices from per-axis coords
        t = self.w + self.c
        offs_nd = np.stack(
            np.meshgrid(
                *[np.arange(ws) for ws in self.window_shape], indexing="ij"
            ),
            axis=0,
        ).reshape(ndim, -1)  # window entry → per-axis offset (ndim, w)
        childs_nd = np.stack(
            np.meshgrid(*[np.arange(s) for s in splits], indexing="ij"),
            axis=0,
        ).reshape(ndim, -1)
        d2 = np.zeros((n_unique, t, t))
        for d in range(ndim):
            bpos = reps[d][combo_ids[d]]  # (nu,)
            coords_d = axis_coords[d][bpos]  # (nu, w_d+s_d)
            # per-axis coordinate of every stencil entry
            ent_w = coords_d[:, offs_nd[d]]  # (nu, w)
            ent_f = coords_d[:, self.window_shape[d] + childs_nd[d]]  # (nu, c)
            ent = np.concatenate([ent_w, ent_f], axis=1)  # (nu, t)
            d2 += (ent[:, :, None] - ent[:, None, :]) ** 2
        self.dist_unique = np.sqrt(d2)
        self.n_unique = n_unique
        self.axis_inv = axis_inv
        self.axis_n_unique = axis_n_unique


def _conv_dn(ndim: int):
    spatial = "DHW"[-ndim:]
    return (f"NC{spatial}", f"OI{spatial}", f"NC{spatial}")


def _extract_windows(x, pad, window_shape, block_shape):
    """(coarse array) → (n_blocks, W) stencil windows via static shifted
    slices (no gather)."""
    views = []
    for off in np.ndindex(*window_shape):
        sl = tuple(
            slice(o, o + b) for o, b in zip(off, block_shape)
        )
        views.append(x[sl])
    return jnp.stack(views, axis=-1).reshape(-1, len(views))


def _extract_blocks(x, splits, block_shape):
    """(fine array) → (n_blocks, C) children blocks via reshape/transpose."""
    ndim = len(splits)
    shp = []
    for b, s in zip(block_shape, splits):
        shp += [b, s]
    x = x.reshape(shp)
    perm = list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2))
    x = x.transpose(perm)
    return x.reshape(-1, int(np.prod(splits)))


def _insert_blocks(y, splits, block_shape):
    """Inverse of :func:`_extract_blocks`: (n_blocks, C) → fine array."""
    ndim = len(splits)
    y = y.reshape(tuple(block_shape) + tuple(splits))
    perm = []
    for i in range(ndim):
        perm += [i, ndim + i]
    y = y.transpose(perm)
    return y.reshape(tuple(b * s for b, s in zip(block_shape, splits)))


class ICRKernel:
    """Refinement kernel on `grid` for an isotropic covariance.

    The covariance is a callable ``cov(r)`` of (arrays of) Euclidean
    distances in chart coordinates.  Pass it at construction for a fixed
    kernel, or call :meth:`matrices` with a (learned) callable inside
    your model.
    """

    def __init__(
        self,
        grid: Grid,
        covariance: Optional[Callable] = None,
        *,
        rtol: float = 1e-5,
        atol: float = 1e-10,
        jitter: float = 1e-10,
    ):
        self.grid = grid
        self.jitter = float(jitter)
        self._layouts = [
            _LevelLayout(grid, lvl, rtol, atol) for lvl in range(grid.depth)
        ]
        # base-level geometry
        g0 = grid.at(0)
        idx0 = np.stack(
            np.meshgrid(*[np.arange(n) for n in g0.shape], indexing="ij"),
            axis=0,
        ).reshape(grid.ndim, -1)
        c0 = g0.index2coord(idx0)
        d = c0[:, :, None] - c0[:, None, :]
        self._base_dist = np.sqrt((d**2).sum(axis=0))
        self.covariance = covariance
        self._fixed_matrices = (
            self.matrices(covariance) if covariance is not None else None
        )

    @property
    def depth(self):
        return self.grid.depth

    def domain_shapes(self):
        """Excitation shapes per level (what the model's latent tree
        must provide)."""
        return list(self.grid.shapes)

    def matrices(self, cov_fn: Callable):
        """Refinement matrices for covariance ``cov_fn(r)`` — batched
        Cholesky over the deduplicated stencils, fully on device."""
        base_cov = cov_fn(jnp.asarray(self._base_dist))
        n0 = base_cov.shape[0]
        base_l = jnp.linalg.cholesky(
            base_cov + self.jitter * jnp.eye(n0, dtype=base_cov.dtype)
        )
        lvl_mats = []
        for lay in self._layouts:
            cov = cov_fn(jnp.asarray(lay.dist_unique))  # (nu, w+c, w+c)
            w = lay.w
            cc = cov[:, :w, :w]
            fc = cov[:, w:, :w]
            ff = cov[:, w:, w:]
            olf = jnp.linalg.solve(cc, fc.swapaxes(-1, -2)).swapaxes(-1, -2)
            cond = ff - olf @ fc.swapaxes(-1, -2)
            ker = jnp.linalg.cholesky(
                cond
                + self.jitter * jnp.eye(lay.c, dtype=cond.dtype)
            )
            lvl_mats.append((olf, ker))
        return base_l, lvl_mats

    def apply(self, xs: Sequence, matrices=None):
        """Refine the per-level excitations `xs` (len = depth+1) into the
        finest-level field."""
        if matrices is None:
            if self._fixed_matrices is None:
                raise ValueError("no covariance set; pass `matrices`")
            matrices = self._fixed_matrices
        base_l, lvl_mats = matrices
        if len(xs) != self.depth + 1:
            raise ValueError(
                f"need {self.depth + 1} excitation levels, got {len(xs)}"
            )
        x = (base_l @ xs[0].reshape(-1)).reshape(self.grid.shapes[0])
        for lay, (olf, ker) in zip(self._layouts, lvl_mats):
            xi = _extract_blocks(
                xs[lay.level + 1], lay.splits, lay.block_shape
            )
            if lay.n_unique == 1 and 1 <= len(lay.block_shape) <= 3:
                # translation-invariant stencil ⇒ the whole refinement is
                # one VALID convolution with prod(splits) output channels
                # (+ the ξ coloring) — one matmul-shaped op, and the coarse field is
                # read once instead of W times
                ndim = len(lay.block_shape)
                lhs = x[None, None]  # (1, 1, spatial...)
                rhs = olf[0].reshape((lay.c, 1) + lay.window_shape)
                dn = jax.lax.conv_dimension_numbers(
                    lhs.shape, rhs.shape, _conv_dn(ndim)
                )
                y = jax.lax.conv_general_dilated(
                    lhs,
                    rhs.astype(x.dtype),
                    window_strides=(1,) * ndim,
                    padding="VALID",
                    dimension_numbers=dn,
                )  # (1, C, B...)
                y = jnp.moveaxis(y[0], 0, -1).reshape(lay.n_blocks, lay.c)
                y = y + xi @ ker[0].T
            elif lay.n_unique == 1:
                win = _extract_windows(
                    x, lay.pad, lay.window_shape, lay.block_shape
                )
                y = win @ olf[0].T + xi @ ker[0].T
            elif len(lay.varying_axes) == 1:
                # one non-uniform axis (e.g. log-radial): per-shell
                # matrices, a single batched matmul over the shell axis
                win = _extract_windows(
                    x, lay.pad, lay.window_shape, lay.block_shape
                )
                k = lay.varying_axes[0]
                inv_k = jnp.asarray(lay.axis_inv[k])
                olf_b = olf[inv_k]  # (B_k, C, W)
                ker_b = ker[inv_k]
                b_k = lay.block_shape[k]

                def regroup(a, width):
                    a = a.reshape(lay.block_shape + (width,))
                    a = jnp.moveaxis(a, k, 0)
                    return a.reshape(b_k, -1, width)

                y = jnp.einsum(
                    "krw,kcw->krc", regroup(win, lay.w), olf_b
                ) + jnp.einsum("krw,kcw->krc", regroup(xi, lay.c), ker_b)
                rest_shape = tuple(
                    b for d, b in enumerate(lay.block_shape) if d != k
                )
                y = y.reshape((b_k,) + rest_shape + (lay.c,))
                y = jnp.moveaxis(y, 0, k).reshape(lay.n_blocks, lay.c)
            else:
                # several non-uniform axes: gather per-block matrices
                win = _extract_windows(
                    x, lay.pad, lay.window_shape, lay.block_shape
                )
                radix = [lay.axis_n_unique[d] for d in lay.varying_axes]
                inv_axes = np.meshgrid(
                    *[
                        lay.axis_inv[d]
                        if lay.axis_inv[d] is not None
                        else np.zeros(lay.block_shape[d], dtype=int)
                        for d in range(len(lay.block_shape))
                    ],
                    indexing="ij",
                )
                uid = np.zeros(lay.block_shape, dtype=np.int64)
                stride = 1
                for d in reversed(range(len(lay.block_shape))):
                    if lay.axis_inv[d] is not None:
                        uid += inv_axes[d] * stride
                        stride *= lay.axis_n_unique[d]
                uid = jnp.asarray(uid.ravel())
                y = jnp.einsum("bcw,bw->bc", olf[uid], win) + jnp.einsum(
                    "bcw,bw->bc", ker[uid], xi
                )
            x = _insert_blocks(y, lay.splits, lay.block_shape)
        return x


def apply_kernel(xs, *, kernel: ICRKernel, matrices=None):
    """Functional alias for :meth:`ICRKernel.apply` (interface parity
    with ``nifty/re/multi_grid/kernel.py:26``)."""
    return kernel.apply(xs, matrices=matrices)
