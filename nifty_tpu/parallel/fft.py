"""Distributed FFT / Hartley transforms for domain-decomposed fields.

The reference never shards the field itself (samples are its only
parallel axis; ``SURVEY.md §5``) — this module is the new ground needed
for ≥10⁹-parameter fields: a **pencil-decomposed** N-D FFT over a named
mesh axis, written with ``shard_map`` so the collectives are explicit
``all_to_all`` transposes instead of XLA-inserted all-gathers:

    axis-0-sharded → local FFT(axes 1..n−1) → all-to-all (transpose) →
    local FFT(axis 0) → all-to-all back.

Per-device memory stays O(N/p) throughout; wall-clock is the local FFTs
plus two transposes riding the interconnect's bisection bandwidth.
"""

from __future__ import annotations

from functools import partial

from jax import lax
from jax import numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = [
    "sharded_fft2",
    "sharded_fftn",
    "sharded_hartley",
    "sharded_hartley2",
]


def _fftn_local(x_block, axis_name: str, *, inverse: bool = False):
    """shard_map body: `x_block` is the local (n0/p, n1, …) pencil."""
    fft = jnp.fft.ifftn if inverse else jnp.fft.fftn
    y = x_block
    if x_block.ndim > 1:
        # FFT along the locally-complete trailing axes
        y = fft(y, axes=tuple(range(1, x_block.ndim)))
    # transpose pencils: (n0/p, n1, …) → (n0, n1/p, …)
    y = lax.all_to_all(y, axis_name, split_axis=1, concat_axis=0, tiled=True)
    # FFT along the now locally-complete leading axis
    y = fft(y, axes=(0,))
    # transpose back to leading-axis pencils
    return lax.all_to_all(y, axis_name, split_axis=0, concat_axis=1, tiled=True)


def sharded_fftn(x, mesh: Mesh, axis_name: str = "fx", *, inverse: bool = False):
    """N-D FFT of `x` sharded along its leading axis over `axis_name`.

    Input and output are sharded ``P(axis_name, None, …)``; the result
    equals ``jnp.fft.fftn(x)`` (up to fp error) but never materializes
    the full field on one device.  The two leading axes must be divisible
    by the mesh-axis size (pad the field to a multiple — powers of two
    are the fast path for the FFT anyway).
    """
    if x.ndim < 2:
        raise ValueError("sharded_fftn expects ndim >= 2 (pencil split)")
    spec = P(axis_name, *((None,) * (x.ndim - 1)))
    # map only the field axis manually; any other mesh axes (e.g. a sample
    # axis of a 2-D mesh) stay automatic, so a vmapped sampler whose batch
    # is sharded over them partitions around this kernel
    fn = shard_map(
        partial(_fftn_local, axis_name=axis_name, inverse=inverse),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        axis_names={axis_name},
    )
    return fn(x.astype(jnp.complex64 if x.dtype == jnp.float32 else jnp.complex128))


def sharded_fft2(x, mesh: Mesh, axis_name: str = "fx", *, inverse: bool = False):
    """2-D alias of :func:`sharded_fftn` (kept for API stability)."""
    if x.ndim != 2:
        raise ValueError("sharded_fft2 expects a 2-D array")
    return sharded_fftn(x, mesh, axis_name, inverse=inverse)


def sharded_hartley2(x, mesh: Mesh, axis_name: str = "fx"):
    """Distributed 2-D Hartley transform (the correlated field's harmonic
    transform): ``H(x) = Re F(x) − Im F(x)`` with the FFT pencil-sharded."""
    f = sharded_fftn(x, mesh, axis_name)
    return (f.real - f.imag).astype(x.dtype)


def sharded_hartley(x, mesh: Mesh, axis_name: str = "fx"):
    """Hartley transform sharded along the leading axis: ndim ≥ 2 inputs
    use the pencil decomposition; 1-D inputs fall back to a gathered local
    transform (a 1-D FFT cannot be usefully pencil-split)."""
    if x.ndim >= 2:
        f = sharded_fftn(x, mesh, axis_name)
        return (f.real - f.imag).astype(x.dtype)
    from ..ops.fft import hartley

    return hartley(x)
