"""Line-of-sight responses for tomography-style forward models.

``SamplingCartesianGridLOS`` integrates a gridded field along straight
rays by sampling equidistant points with multilinear ``map_coordinates``
and summing — a batched gather per ray, vmapped over rays (reference:
``nifty/re/extra/sampling_los.py:30``; independent implementation).

``ExactGridLOS`` is the exact-traversal counterpart (reference:
``nifty/cl/library/los_response.py:34-103``): ray-cell intersections and
segment lengths are computed offline with numpy at construction, the
device apply is a padded batched gather-reduce (its AD transpose is a
scatter-add), and Gaussian endpoint (parallax) uncertainty reweights the
segments by the survival function of the inverse-distance error — the
same statistical model as the reference.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
from jax import numpy as jnp

from .model import LazyModel
from .utils.tree import ShapeWithDtype

__all__ = ["ExactGridLOS", "SamplingCartesianGridLOS"]


def _integrate_one_los(
    x, start, end, *, distances, shape, n_sampling_points, order
):
    from jax.scipy.ndimage import map_coordinates

    # physical position → (fractional) pixel index
    l2i = ((shape - 1.0) / shape) / distances
    si = start * l2i
    ei = end * l2i
    step = (ei - si) / n_sampling_points
    t = jnp.arange(n_sampling_points) + 0.5
    pts = si[:, None] + step[:, None] * t[None, :]
    length = jnp.linalg.norm(end - start)
    vals = map_coordinates(x, pts, order=order, cval=jnp.nan)
    return vals.sum() * (length / n_sampling_points)


class SamplingCartesianGridLOS(LazyModel):
    """Line-of-sight integrals from `start` to `end` points over a regular
    Cartesian grid; either endpoint set may be shared across rays."""

    start: jax.Array = dataclasses.field(metadata=dict(static=False))
    end: jax.Array = dataclasses.field(metadata=dict(static=False))

    def __init__(
        self,
        start,
        end,
        *,
        shape,
        distances,
        n_sampling_points: int = 500,
        interpolation_order: int = 1,
        dtype=None,
    ):
        self.start = jnp.asarray(start)
        self.end = jnp.asarray(end)
        shape_arr = jnp.asarray(shape, dtype=float)
        dist_arr = jnp.asarray(distances, dtype=float)
        self._integrate = partial(
            _integrate_one_los,
            distances=dist_arr,
            shape=shape_arr,
            n_sampling_points=int(n_sampling_points),
            order=int(interpolation_order),
        )
        tgt_shape = (self.end if self.end.ndim >= self.start.ndim else self.start).shape[:-1]
        super().__init__(
            domain=ShapeWithDtype(tuple(shape), dtype),
            target=ShapeWithDtype(tgt_shape, dtype),
        )

    def __call__(self, x):
        in_axes = (None, 0, 0)
        if self.start.ndim < self.end.ndim:
            in_axes = (None, None, 0)
        elif self.start.ndim > self.end.ndim:
            in_axes = (None, 0, None)
        return jax.vmap(self._integrate, in_axes=in_axes)(x, self.start, self.end)


# --- exact ray-cell traversal (cl-style LOSResponse) -------------------------


def _gaussian_survival(x):
    from scipy.special import erfc

    return 0.5 * erfc(x / np.sqrt(2.0))


def _clip_to_box(p0, d, shp):
    """Entry/exit parameters of the segment p0 + t*d, t in [0,1], against
    the box [0, shp] per the reference's conventions (degenerate axes get
    pushed to ±1e12; the interval is shrunk by 1e-7 to dodge crossings
    exactly on cell boundaries)."""
    safe_d = np.where(d == 0.0, 1e-12, d)
    t_lo = np.where(d == 0.0, ((p0 > 0) - 0.5) * 1e12, -p0 / safe_d)
    t_hi = np.where(d == 0.0, ((p0 < shp) - 0.5) * -1e12, (shp - p0) / safe_d)
    tmin = max(0.0, np.minimum(t_lo, t_hi).max())
    tmax = min(1.0, np.maximum(t_lo, t_hi).min())
    tmax = max(tmin, tmax)
    return tmin + 1e-7, tmax - 1e-7


def _traverse_ray(p0, d, shp, strides):
    """All cell crossings of one ray (pixel coords): returns the sorted
    crossing parameters in (tmin, tmax), the flat index of the entry cell,
    and the per-crossing flat-index increments."""
    tmin, tmax = _clip_to_box(p0, d, np.asarray(shp, float))
    if tmin >= tmax:
        return None
    ts, steps = [], []
    for j, dj in enumerate(d):
        if dj == 0.0:
            continue
        # first integer coordinate crossed after tmin, then equidistant
        c0 = np.ceil(p0[j] + dj * tmin)
        if dj < 0.0:
            c0 -= 1.0
        t0 = (c0 - p0[j]) / dj
        tj = np.arange(t0, tmax, abs(1.0 / dj))
        ts.append(tj)
        steps.append(
            np.full(tj.size, strides[j] if dj > 0 else -strides[j], np.int64)
        )
    ts = np.concatenate(ts) if ts else np.empty(0)
    steps = np.concatenate(steps) if steps else np.empty(0, np.int64)
    order = np.argsort(ts)
    entry_cell = int(np.sum(np.asarray(p0 + tmin * d, np.int64) * strides))
    return tmin, tmax, ts[order], entry_cell, steps[order]


def _ray_cells_and_weights(
    start, end, shape, distances, *, length, lo, hi, sigma, survival
):
    """Exact traversal of one ray: (flat cell indices, segment weights).
    Weights are physical segment lengths, reweighted by the endpoint-
    uncertainty survival function on (lo, hi] and cut beyond hi."""
    shp = np.asarray(shape)
    strides = np.ones(len(shp), np.int64)
    for j in range(len(shp) - 2, -1, -1):
        strides[j] = strides[j + 1] * shp[j + 1]
    d = end - start
    tr = _traverse_ray(start, d, shp, strides)
    if tr is None:
        return np.empty(0, np.int64), np.empty(0)
    tmin, tmax, ts, entry_cell, steps = tr
    scale = np.linalg.norm(d * distances)
    bounds = np.concatenate(([tmin], ts, [tmax])) * scale
    wgt = np.diff(bounds)
    cells = entry_cell + np.concatenate(([0], np.cumsum(steps)))
    # endpoint uncertainty: segments past `hi` vanish; between `lo` and
    # `hi` the chance that the (inverse-Gaussian-distributed) endpoint
    # lies beyond the segment midpoint reweights it
    s_mid = 0.5 * (bounds[:-1] + bounds[1:])
    wgt = np.where(s_mid > hi, 0.0, wgt)
    tail = (s_mid > lo) & (s_mid <= hi)
    if np.any(tail):
        wgt = np.where(
            tail,
            wgt * survival((-1.0 / np.maximum(s_mid, 1e-300) + 1.0 / length)
                           / sigma),
            wgt,
        )
    return cells, wgt


class ExactGridLOS(LazyModel):
    """Exact line-of-sight response over a regular Cartesian grid.

    Counterpart of the reference's sparse-matrix
    ``LOSResponse`` (``nifty/cl/library/los_response.py:103``): the exact
    ray-cell intersection segments are computed offline (numpy) and stored
    as per-ray padded ``(cell index, weight)`` tables; the device apply is
    one batched ``take`` plus a weighted reduction per ray — its transpose
    under JAX AD is the matching scatter-add.  With ``sigmas`` the
    endpoint of each ray is treated as uncertain with Gaussian
    inverse-distance error (astrophysical parallax model) and the response
    returns the expectation over endpoints, truncated at
    ``truncation``·sigma — same model as the reference.

    Parameters mirror the reference: ``starts``/``ends`` are ``(n_los,
    ndim)`` physical coordinates (note: the reference uses ``(ndim,
    n_los)``; this class follows the row-per-ray convention of
    ``SamplingCartesianGridLOS``).
    """

    idx: jax.Array = dataclasses.field(metadata=dict(static=False))
    wgt: jax.Array = dataclasses.field(metadata=dict(static=False))

    def __init__(
        self,
        starts,
        ends,
        *,
        shape,
        distances,
        sigmas=None,
        truncation: float = 3.0,
        dtype=None,
    ):
        starts = np.atleast_2d(np.asarray(starts, float))
        ends = np.atleast_2d(np.asarray(ends, float))
        if starts.shape != ends.shape:
            raise ValueError("starts/ends shape mismatch")
        n_los, ndim = starts.shape
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        if len(shape) != ndim:
            raise ValueError("shape/ray dimension mismatch")
        distances = np.broadcast_to(
            np.atleast_1d(np.asarray(distances, float)), (ndim,)
        )

        diffs = ends - starts
        lengths = np.linalg.norm(diffs, axis=1)
        if sigmas is None:
            sig = np.zeros(n_los)
            reach = lengths
            lo = hi = lengths  # no uncertainty band
        else:
            sig = np.asarray(sigmas, float)
            if sig.shape != (n_los,):
                raise ValueError("sigmas must have one entry per ray")
            inv = 1.0 / lengths
            if np.any(inv - truncation * sig <= 0):
                raise ValueError(
                    "truncation too high: negative maximum distances"
                )
            reach = 1.0 / (inv - truncation * sig)
            lo = 1.0 / (inv + truncation * sig)
            hi = reach

        # pixel coordinates (reference convention: physical origin sits at
        # pixel coordinate +0.5)
        p_start = starts / distances + 0.5
        unit = diffs / np.where(lengths == 0.0, 1.0, lengths)[:, None]
        p_end = (starts + unit * reach[:, None]) / distances + 0.5

        per_ray = [
            _ray_cells_and_weights(
                p_start[i],
                p_end[i],
                shape,
                distances,
                length=lengths[i],
                lo=lo[i],
                hi=hi[i],
                sigma=max(sig[i], 1e-300),
                survival=_gaussian_survival,
            )
            for i in range(n_los)
        ]
        width = max((c.size for c, _ in per_ray), default=1) or 1
        idx = np.zeros((n_los, width), np.int32)
        wgt = np.zeros((n_los, width), np.float32)
        for i, (c, w) in enumerate(per_ray):
            idx[i, : c.size] = c
            wgt[i, : w.size] = w
        self.idx = jnp.asarray(idx)
        self.wgt = jnp.asarray(wgt)
        super().__init__(
            domain=ShapeWithDtype(shape, dtype),
            target=ShapeWithDtype((n_los,), dtype),
        )

    def __call__(self, x):
        vals = jnp.take(x.ravel(), self.idx, axis=0)
        return jnp.sum(self.wgt.astype(vals.dtype) * vals, axis=-1)
