"""Structural operator zoo — functional equivalents of nifty.cl's linear
operators.

In the classical reference every structural transform is a
``LinearOperator`` class carrying a hand-written adjoint
(``nifty/cl/operators/simple_linear_operators.py``,
``diagonal_operator.py``, ``contraction_operator.py``, …).  Here each is a
plain jittable function (or a factory returning one): linearity is a
property, not a class, and the adjoint comes for free from
``jax.linear_transpose`` (:func:`adjoint`).  All of them compose with
models via ``ChainModel``/``Likelihood.amend`` and are verified by
``extra.check_linear_model``.

Nothing in here allocates at call time beyond its output; every function
lowers to a handful of XLA ops (slice, pad, reshape, gather of static
indices, matmul) that fuse into surrounding computations.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import jax
import jax.flatten_util  # noqa: F401  (registers jax.flatten_util)
import numpy as np
from jax import numpy as jnp

from .utils.tree import Vector

__all__ = [
    "adjoint",
    "scaling",
    "diagonal",
    "adder",
    "mask",
    "mask_adjoint",
    "zero_pad",
    "central_slice",
    "extract_at_indices",
    "contraction",
    "outer_product",
    "matrix_product",
    "block_diagonal",
    "transpose_field",
    "regrid",
    "linear_interpolation",
    "func_convolution",
    "squeeze",
    "prepend_key",
    "value_inserter",
    "multifield_to_vector",
    "vector_to_multifield",
    "partial_conjugate",
    "linear_einsum",
]


def adjoint(f: Callable, example_input):
    """Transpose of the linear map `f`: the explicit counterpart of the
    reference's ``LinearOperator.adjoint`` (``nifty/cl/operators/
    linear_operator.py:150`` mode=ADJOINT_TIMES).

    `example_input` may be a concrete pytree or a pytree of
    ``ShapeWithDtype``; the returned function maps cotangents of `f`'s
    output to the input space.
    """
    def adj(y):
        return jax.linear_transpose(f, example_input)(y)[0]

    return adj


def scaling(factor):
    """× a scalar.  Ref: ``nifty/cl/operators/scaling_operator.py:24``."""
    return lambda x: jax.tree_util.tree_map(lambda a: factor * a, x)


def diagonal(diag):
    """Pointwise multiply by a fixed field.  Ref: ``nifty/cl/operators/
    diagonal_operator.py:51``."""
    if isinstance(diag, (dict, Vector)):
        return lambda x: jax.tree_util.tree_map(lambda d, a: d * a, diag, x)
    diag = jnp.asarray(diag)
    return lambda x: diag * x


def adder(offset):
    """+ a fixed field (affine, not linear).  Ref: ``nifty/cl/operators/
    adder.py``."""
    if isinstance(offset, (dict, Vector)):
        return lambda x: jax.tree_util.tree_map(
            lambda o, a: o + a, offset, x
        )
    return lambda x: x + offset


def mask(keep):
    """Project to the entries where `keep` is True, returning a 1-D array
    of the surviving values (the data-space view of a masked sky).

    Ref: ``nifty/cl/operators/mask_operator.py`` (MaskOperator flags
    *excluded* pixels; here `keep` flags included ones — pass ``~flags``
    for the reference convention).  The gather indices are static, so
    under jit this is a single XLA gather with a compile-time index set.
    """
    keep = np.asarray(keep, bool)
    (idx,) = np.nonzero(keep.ravel())
    idx = jnp.asarray(idx)

    def apply(x):
        return x.reshape(-1)[idx]

    return apply


def mask_adjoint(keep):
    """Scatter masked values back into the full grid (zeros elsewhere)."""
    keep = np.asarray(keep, bool)
    (idx,) = np.nonzero(keep.ravel())
    idx = jnp.asarray(idx)
    shape = keep.shape
    n = int(np.prod(shape))

    def apply(y):
        # unique_indices: mask indices never repeat — keeps the scatter
        # transposable (and cheaper on device)
        return (
            jnp.zeros((n,), y.dtype)
            .at[idx]
            .set(y, unique_indices=True, indices_are_sorted=True)
            .reshape(shape)
        )

    return apply


def zero_pad(new_shape: Sequence[int], *, center: bool = False):
    """Embed a field into a larger grid, padding with zeros.

    ``center=False`` pads at the end of each axis (position-space
    embedding).  ``center=True`` follows the reference FieldZeroPadder's
    *harmonic-layout* convention (``nifty/cl/operators/
    field_zero_padder.py:85-95``): the zeros are inserted at the Nyquist
    split — the low-|k| head ``x[:n//2+1]`` keeps its position at the
    start of the axis and the negative-frequency tail ``x[-(n//2):]``
    moves to the end, so an FFT-layout spectrum is upsampled without
    scrambling (the even-length Nyquist bin is duplicated into head and
    tail, matching the reference).
    """
    new_shape = tuple(int(s) for s in new_shape)

    def apply(x):
        if x.ndim != len(new_shape):
            raise ValueError(f"rank mismatch: {x.shape} vs {new_shape}")
        if any(new < old for old, new in zip(x.shape, new_shape)):
            raise ValueError("zero_pad target must not be smaller")
        if not center:
            pads = [(0, new - old, 0) for old, new in zip(x.shape, new_shape)]
            return jax.lax.pad(x, jnp.zeros((), x.dtype), pads)
        for ax, new in enumerate(new_shape):
            old = x.shape[ax]
            if new == old:
                continue
            nyq = old // 2
            idx = (slice(None),) * ax
            out = jnp.zeros(x.shape[:ax] + (new,) + x.shape[ax + 1 :], x.dtype)
            out = out.at[idx + (slice(0, nyq + 1),)].set(
                x[idx + (slice(0, nyq + 1),)]
            )
            if nyq > 0:
                out = out.at[idx + (slice(new - nyq, new),)].set(
                    x[idx + (slice(old - nyq, old),)]
                )
            x = out
        return x

    return apply


def central_slice(new_shape: Sequence[int], *, center: bool = False):
    """Adjoint-of-zero-pad style restriction: cut the (corner or central)
    `new_shape` region.  Ref: ``nifty/cl/operators/selection_operators.py``
    ``SliceOperator``."""
    new_shape = tuple(int(s) for s in new_shape)

    def apply(x):
        starts = [
            (o - n) // 2 if center else 0 for o, n in zip(x.shape, new_shape)
        ]
        return jax.lax.slice(
            x, starts, [s + n for s, n in zip(starts, new_shape)]
        )

    return apply


def extract_at_indices(indices, *, axis: int = 0):
    """Gather rows at static `indices` along `axis`.  Ref: ``nifty/cl/
    operators/simple_linear_operators.py:515`` ``ExtractAtIndices``."""
    indices = jnp.asarray(indices)
    return lambda x: jnp.take(x, indices, axis=axis)


def contraction(axes: Optional[Union[int, Sequence[int]]] = None, *,
                weights=None, mean: bool = False):
    """Sum (or weighted sum / mean) over `axes`.  Ref: ``nifty/cl/
    operators/contraction_operator.py`` (the reference's dvol weighting =
    pass ``weights=dvol``)."""
    if axes is not None and np.isscalar(axes):
        axes = (int(axes),)

    def apply(x):
        y = x if weights is None else x * weights
        return jnp.mean(y, axis=axes) if mean else jnp.sum(y, axis=axes)

    return apply


def outer_product(field):
    """x ↦ field ⊗ x.  Ref: ``nifty/cl/operators/outer_product_operator.py``."""
    field = jnp.asarray(field)
    return lambda x: jnp.tensordot(field, x, axes=0)


def matrix_product(matrix, *, axis: int = -1):
    """Apply a dense matrix along one axis (a matmul).  Ref: ``nifty/cl/
    operators/matrix_product_operator.py``."""
    matrix = jnp.asarray(matrix)

    def apply(x):
        moved = jnp.moveaxis(x, axis, -1)
        out = moved @ matrix.T
        return jnp.moveaxis(out, -1, axis)

    return apply


def block_diagonal(fns: Mapping[str, Callable]):
    """Apply one (linear) function per key of a dict input; keys without
    an entry in `fns` pass through unchanged.  A key in `fns` that is
    absent from the input raises (so a typo'd operator key cannot be
    silently dropped — the reference BlockDiagonalOperator requires the
    operator dict to match the domain).  Ref:
    ``nifty/cl/operators/block_diagonal_operator.py``."""
    def apply(x):
        xd = x.tree if isinstance(x, Vector) else x
        unknown = set(fns) - set(xd)
        if unknown:
            raise KeyError(
                f"block_diagonal: keys {sorted(unknown)} not in input "
                f"domain {sorted(xd)}"
            )
        out = {k: fns[k](v) if k in fns else v for k, v in xd.items()}
        return Vector(out) if isinstance(x, Vector) else out

    return apply


def transpose_field(perm: Sequence[int]):
    """Permute field axes.  Ref: ``nifty/cl/operators/transpose_operator.py``."""
    perm = tuple(int(p) for p in perm)
    return lambda x: jnp.transpose(x, perm)


def regrid(new_shape: Sequence[int]):
    """Linear regridding between regular grids of the same extent —
    separable multilinear interpolation weights per axis, exactly linear
    in the input.  Ref: ``nifty/cl/operators/regridding_operator.py``.

    Implemented as one sparse-weight matmul per axis (two taps per output
    pixel) rather than a gather.
    """
    new_shape = tuple(int(s) for s in new_shape)

    def _axis_weights(n_out, n_in, dtype):
        # output pixel centers in input fractional index space
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        pos = np.clip(pos, 0.0, n_in - 1.0)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        w_hi = pos - lo
        mat = np.zeros((n_out, n_in))
        np.add.at(mat, (np.arange(n_out), lo), 1.0 - w_hi)
        np.add.at(mat, (np.arange(n_out), hi), w_hi)
        return jnp.asarray(mat, dtype)

    def apply(x):
        for ax, n_out in enumerate(new_shape):
            if x.shape[ax] != n_out:
                w = _axis_weights(n_out, x.shape[ax], x.dtype)
                x = jnp.moveaxis(
                    jnp.tensordot(w, jnp.moveaxis(x, ax, 0), axes=1), 0, ax
                )
        return x

    return apply


def linear_interpolation(positions, *, distances, offset=None):
    """Multilinear interpolation of a regular grid at arbitrary physical
    `positions` (shape ``(ndim, n_points)``).  Linear in the field, so the
    response of an instrument sampling a sky at point locations.  Sampling
    positions wrap periodically (the grid is a torus), matching the
    reference LinearInterpolator's boundary convention.  Ref:
    ``nifty/cl/operators/linear_interpolation.py:32``."""
    positions = np.asarray(positions, float)
    ndim, _ = positions.shape
    distances = (
        np.full(ndim, float(distances))
        if np.isscalar(distances)
        else np.asarray(distances, float)
    )
    offset = np.zeros(ndim) if offset is None else np.asarray(offset, float)
    frac = (positions - offset[:, None]) / distances[:, None]
    frac = jnp.asarray(frac)

    def apply(x):
        return jax.scipy.ndimage.map_coordinates(
            x, list(frac), order=1, mode="wrap"
        )

    return apply


def func_convolution(shape: Sequence[int], distances, func: Callable):
    """Convolution with an isotropic kernel ``func(r)`` on a periodic
    regular grid via the convolution theorem (one forward + one inverse
    rFFT).  Ref: ``nifty/cl/operators/convolution_operators.py:30``
    ``FuncConvolutionOperator``."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    distances = (
        (float(distances),) * ndim
        if np.isscalar(distances)
        else tuple(float(d) for d in distances)
    )
    # radii with periodic wrap-around (minimum-image convention)
    axes = [
        np.minimum(np.arange(n), n - np.arange(n)) * d
        for n, d in zip(shape, distances)
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(sum(m**2 for m in mesh))
    dvol = float(np.prod(distances))
    kern = np.asarray(func(r)) * dvol
    kern_f = jnp.asarray(np.fft.rfftn(kern))

    def apply(x):
        if jnp.iscomplexobj(x):
            # the kernel is real: convolve real and imag parts separately
            return apply(x.real) + 1j * apply(x.imag)
        return jnp.fft.irfftn(jnp.fft.rfftn(x) * kern_f, s=shape)

    return apply


def squeeze(axis=None):
    """Drop size-1 axes.  Ref: ``nifty/cl/operators/
    simple_linear_operators.py:576`` ``SqueezeOperator``."""
    return lambda x: jnp.squeeze(x, axis=axis)


def prepend_key(key: str):
    """Nest a dict input under `key`.  Ref: ``nifty/cl/operators/
    simple_linear_operators.py:447`` ``PrependKey``."""
    def apply(x):
        xd = x.tree if isinstance(x, Vector) else x
        return {key: xd}

    return apply


def value_inserter(shape: Sequence[int], index):
    """Insert a scalar at a static position of a zero field.  Ref:
    ``nifty/cl/operators/value_inserter.py``."""
    shape = tuple(int(s) for s in shape)
    index = tuple(int(i) for i in index)

    def apply(x):
        return jnp.zeros(shape, jnp.result_type(x)).at[index].set(
            jnp.squeeze(x)
        )

    return apply


def multifield_to_vector(x):
    """Ravel a pytree into one flat vector.  Ref: ``nifty/cl/operators/
    multifield2vector.py``."""
    flat, _ = jax.flatten_util.ravel_pytree(
        x.tree if isinstance(x, Vector) else x
    )
    return flat


def vector_to_multifield(example):
    """Inverse of :func:`multifield_to_vector` for the given structure."""
    ex = example.tree if isinstance(example, Vector) else example
    _, unravel = jax.flatten_util.ravel_pytree(ex)

    def apply(flat):
        out = unravel(flat)
        return Vector(out) if isinstance(example, Vector) else out

    return apply


def partial_conjugate(keys: Sequence[str]):
    """Conjugate the listed keys of a dict input.  Ref: ``nifty/cl/
    operators/simple_linear_operators.py`` ``PartialConjugate``."""
    keys = frozenset(keys)

    def apply(x):
        xd = x.tree if isinstance(x, Vector) else x
        out = {
            k: jnp.conj(v) if k in keys else v for k, v in xd.items()
        }
        return Vector(out) if isinstance(x, Vector) else out

    return apply


def linear_einsum(subscripts: str, **tensors):
    """Einsum with fixed named tensors; the input supplies the remaining
    operand.  Ref: ``nifty/cl/operators/einsum.py`` ``LinearEinsum``.

    `subscripts` must mention the input operand *last*, e.g.
    ``linear_einsum("ij,j->i", m=mat)`` maps ``x ↦ mat @ x``.
    """
    consts = [jnp.asarray(v) for v in tensors.values()]
    return lambda x: jnp.einsum(subscripts, *consts, x)
