"""Expansion of unique-|k| mode tables onto harmonic grids.

The exact (reference-parity) correlated field stores one amplitude value
per *unique* |k| and expands it to the harmonic grid — a per-pixel gather
(reference kernel: ``nifty/re/correlated_field.py:889-907``), whose
transpose in the Fisher metric is a scatter-add.

Two layout choices keep the index count and the gathered slices small:

1. Every expansion gathers from an ``(U, 2)`` table — a zero column is
   padded when only one value is needed — so that vmap batches ride along
   as extra columns of the same gather.
2. On a square isotropic grid, |k| on the non-redundant ``(H, H)`` octant
   is symmetric under transposition; the upper triangle packs *exactly*
   (``H`` odd) into a rectangular-full-packed ``((H+1)/2, H)`` layout
   whose unpack/fold are pure slice/transpose/mask ops.  Gather and
   scatter index counts halve.

Both were tuned on the accelerator this code was first written for;
whether they pay on the GPU is an open measurement (ROADMAP S7).

The expansion is a first-class primitive (impl / linear JVP / custom
transpose / batching) so it works under ``jax.linearize`` +
``linear_transpose`` (the metric hot path) and under ``vmap`` (sampled
VI, VModel): the transpose is a single narrow scatter-add of the packed
cotangent, never a (pixels, columns)-wide scatter.
"""

from __future__ import annotations

from collections import namedtuple

import jax
import numpy as np
from jax import numpy as jnp

__all__ = [
    "build_expand_layout",
    "mode_expand",
    "ExpandLayout",
]

ExpandLayout = namedtuple(
    "ExpandLayout",
    ("kind", "core_shape", "packed_shape", "n_unique"),
)

def _rfp_index_table(core: np.ndarray) -> np.ndarray:
    """Pack the upper triangle of a symmetric (H, H) index table (H odd)
    into the rectangular-full-packed ((H+1)/2, H) layout."""
    H = core.shape[0]
    m = H // 2  # H = 2m + 1
    R = np.empty((m + 1, H), dtype=core.dtype)
    # right block: full rectangle rows 0..m, cols m+1..H-1
    R[:, m + 1 :] = core[: m + 1, m + 1 :]
    # left square S (m+1, m+1): upper triangle holds core[a, b] (a<=b<=m);
    # strict lower S[a, b] (a>b) holds core[m+1+b, m+a]
    aa, bb = np.meshgrid(np.arange(m + 1), np.arange(m + 1), indexing="ij")
    upper = core[: m + 1, : m + 1]
    lower_src = core[np.minimum(m + 1 + bb, H - 1), np.minimum(m + aa, H - 1)]
    R[:, : m + 1] = np.where(aa <= bb, upper, lower_src)
    return R


def build_expand_layout(core_idx: np.ndarray, n_unique: int):
    """Build the static layout + packed index array for a mode table.

    Returns ``(packed_idx, layout)`` where ``packed_idx`` is an int32
    device-storable index array (a dynamic pytree leaf in models) and
    ``layout`` is hashable static metadata.
    """
    core_idx = np.asarray(core_idx)
    core_shape = tuple(int(n) for n in core_idx.shape)
    if (
        core_idx.ndim == 2
        and core_shape[0] == core_shape[1]
        and core_shape[0] % 2 == 1
        and np.array_equal(core_idx, core_idx.T)
    ):
        R = _rfp_index_table(core_idx)
        return (
            jnp.asarray(np.ascontiguousarray(R, dtype=np.int32)),
            ExpandLayout(
                kind="rfp2",
                core_shape=core_shape,
                packed_shape=tuple(int(n) for n in R.shape),
                n_unique=int(n_unique),
            ),
        )
    return (
        jnp.asarray(np.ascontiguousarray(core_idx, dtype=np.int32)),
        ExpandLayout(
            kind="flat",
            core_shape=core_shape,
            packed_shape=core_shape,
            n_unique=int(n_unique),
        ),
    )


def _sym_from_upper(up):
    """(..., n, n) upper-triangular (incl. diagonal) -> symmetric."""
    return up + jnp.triu(up, 1).swapaxes(-2, -1)


def _upper_cot(cot):
    """Adjoint of :func:`_sym_from_upper`."""
    return jnp.triu(cot) + jnp.triu(cot.swapaxes(-2, -1), 1)


def _unpack_rfp2(G, layout, batched):
    """(m+1, H[, B]) packed gather result -> (H, H[, B]) core."""
    H = layout.core_shape[0]
    m = H // 2
    # move any trailing batch columns out of the way: operate on axes -2/-1
    if batched:
        G = jnp.moveaxis(G, -1, 0)
    S = G[..., :, : m + 1]
    rect = G[..., :, m + 1 :]
    tri = jnp.triu(S)
    C11 = _sym_from_upper(tri)
    B2u = jnp.tril(S, -1).swapaxes(-2, -1)  # [b, a] holds core[m+1+b, m+a]
    C22u = B2u[..., :m, 1:]  # (m, m) upper incl diag of block22
    C22 = _sym_from_upper(C22u)
    top = jnp.concatenate([C11, rect], axis=-1)
    bottom = jnp.concatenate([rect.swapaxes(-2, -1), C22], axis=-1)
    core = jnp.concatenate([top, bottom], axis=-2)
    if batched:
        core = jnp.moveaxis(core, 0, -1)
    return core


def _fold_rfp2(cot, layout, batched):
    """Exact adjoint of :func:`_unpack_rfp2`."""
    H = layout.core_shape[0]
    m = H // 2
    if batched:
        cot = jnp.moveaxis(cot, -1, 0)
    u11 = cot[..., : m + 1, : m + 1]
    u12 = cot[..., : m + 1, m + 1 :]
    u21 = cot[..., m + 1 :, : m + 1]
    u22 = cot[..., m + 1 :, m + 1 :]
    rect_cot = u12 + u21.swapaxes(-2, -1)
    tri_cot = jnp.triu(_upper_cot(u11))
    c22u_cot = _upper_cot(u22)  # (m, m)
    pad = [(0, 0)] * (c22u_cot.ndim - 2) + [(0, 1), (1, 0)]
    b2u_cot = jnp.pad(c22u_cot, pad)  # (m+1, m+1), col 0 & row m zero
    s_lower_cot = jnp.tril(b2u_cot.swapaxes(-2, -1), -1)
    S_cot = tri_cot + s_lower_cot
    R_cot = jnp.concatenate([S_cot, rect_cot], axis=-1)
    if batched:
        R_cot = jnp.moveaxis(R_cot, 0, -1)
    return R_cot


def _expand_impl(tab, packed_idx, *, layout):
    """tab (U,) or (U, B) -> core_shape or core_shape + (B,)."""
    single = tab.ndim == 1
    flat = _mode_expand_flat_p.bind(tab, packed_idx, layout=layout)
    G = flat.reshape(
        layout.packed_shape + (() if single else (tab.shape[-1],))
    )
    G2 = G[..., None] if single else G
    if layout.kind == "rfp2":
        core = _unpack_rfp2(G2, layout, batched=True)
    else:
        core = G2
    return core[..., 0] if single else core


def _expand_abstract(tab, packed_idx, *, layout):
    shape = layout.core_shape + (() if tab.ndim == 1 else (tab.shape[-1],))
    return jax.core.ShapedArray(shape, tab.dtype)


def _expand_flat_impl(tab, packed_idx, *, layout):
    """Flat expansion core: (U,) or (U, B) table → (P,) / (P, B) packed
    values."""
    single = tab.ndim == 1
    idx_flat = packed_idx.ravel()
    t2 = tab[:, None] if single else tab
    if t2.shape[-1] < 2:
        # gather 2-wide slices even when one column is padding (module
        # docstring, point 1)
        t2 = jnp.concatenate([t2, jnp.zeros_like(t2)], axis=-1)
    g = t2[idx_flat][..., : 1 if single else tab.shape[-1]]
    return g[..., 0] if single else g


def _make_expand_flat_primitive():
    """Flat expansion as a primitive, the transpose partner of the flat
    collapse: the pair keeps the packed gather and scatter-add as single
    operations through linearize, transpose and vmap."""
    from jax.extend.core import Primitive
    from jax.interpreters import ad, batching, mlir

    prim = Primitive("nifty_mode_expand_flat")
    prim.def_impl(
        lambda t, idx, *, layout: _expand_flat_impl(t, idx, layout=layout)
    )

    def _abstract(t, idx, *, layout):
        n_packed = int(np.prod(layout.packed_shape))
        shape = (n_packed,) + (() if t.ndim == 1 else (t.shape[-1],))
        return jax.core.ShapedArray(shape, t.dtype)

    prim.def_abstract_eval(_abstract)
    ad.defjvp(
        prim, lambda dt, t, idx, *, layout: prim.bind(dt, idx, layout=layout),
        None,
    )

    def _transpose(cot, t, packed_idx, *, layout):
        from jax.interpreters import ad as _ad

        if not _ad.is_undefined_primal(t):
            raise NotImplementedError("expand_flat transpose w.r.t. indices")
        return _mode_collapse_p.bind(cot, packed_idx, layout=layout), None

    ad.primitive_transposes[prim] = _transpose

    def _batch(args, dims, *, layout):
        from jax.interpreters import batching as _b

        t, idx = args
        dt, di = dims
        if di is not _b.not_mapped:
            out = jax.vmap(
                lambda t_, i_: _expand_flat_impl(t_, i_, layout=layout),
                in_axes=(None if dt is _b.not_mapped else dt, di),
            )(t, idx)
            return out, 0
        if t.ndim - 1 != 1:
            out = jax.vmap(
                lambda t_: _expand_flat_impl(t_, idx, layout=layout),
                in_axes=dt,
            )(t)
            return out, 0
        t2 = jnp.moveaxis(t, dt, -1)  # batch as gather-slice columns
        out = prim.bind(t2, idx, layout=layout)
        return out, out.ndim - 1

    batching.primitive_batchers[prim] = _batch
    mlir.register_lowering(
        prim,
        mlir.lower_fun(
            lambda t, idx, *, layout: _expand_flat_impl(t, idx, layout=layout),
            multiple_results=False,
        ),
    )
    return prim


_mode_expand_flat_p = _make_expand_flat_primitive()


def _collapse_impl(c_flat, packed_idx, *, layout):
    """Flat collapse (the expansion's adjoint core): (P,) or (P, B)
    packed cotangents → (n_unique,) / (n_unique, B) scatter-add."""
    out = jnp.zeros((layout.n_unique,) + c_flat.shape[1:], c_flat.dtype)
    return out.at[packed_idx.ravel()].add(c_flat)


def _make_collapse_primitive():
    """The flat collapse as its own primitive, so that a batched
    transpose rides the batch as trailing scatter columns (one
    scatter-add) instead of a vmapped scatter per batch element."""
    from jax.extend.core import Primitive
    from jax.interpreters import ad, batching, mlir

    prim = Primitive("nifty_mode_collapse")
    prim.def_impl(
        lambda c, idx, *, layout: _collapse_impl(c, idx, layout=layout)
    )

    def _abstract(c, idx, *, layout):
        shape = (layout.n_unique,) + (
            () if c.ndim == 1 else (c.shape[-1],)
        )
        return jax.core.ShapedArray(shape, c.dtype)

    prim.def_abstract_eval(_abstract)
    ad.defjvp(
        prim, lambda dc, c, idx, *, layout: prim.bind(dc, idx, layout=layout),
        None,
    )

    def _collapse_transpose(cot, c, packed_idx, *, layout):
        from jax.interpreters import ad as _ad

        if not _ad.is_undefined_primal(c):
            raise NotImplementedError("collapse transpose w.r.t. indices")
        return (
            _mode_expand_flat_p.bind(cot, packed_idx, layout=layout),
            None,
        )

    ad.primitive_transposes[prim] = _collapse_transpose

    def _collapse_batch(args, dims, *, layout):
        from jax.interpreters import batching as _b

        c, idx = args
        dc, di = dims
        if di is not _b.not_mapped:
            out = jax.vmap(
                lambda c_, i_: _collapse_impl(c_, i_, layout=layout),
                in_axes=(None if dc is _b.not_mapped else dc, di),
            )(c, idx)
            return out, 0
        if c.ndim - 1 != 1:
            out = jax.vmap(
                lambda c_: _collapse_impl(c_, idx, layout=layout),
                in_axes=dc,
            )(c)
            return out, 0
        # batch as trailing scatter columns
        c2 = jnp.moveaxis(c, dc, -1)
        out = prim.bind(c2, idx, layout=layout)
        return out, out.ndim - 1

    batching.primitive_batchers[prim] = _collapse_batch
    mlir.register_lowering(
        prim,
        mlir.lower_fun(
            lambda c, idx, *, layout: _collapse_impl(c, idx, layout=layout),
            multiple_results=False,
        ),
    )
    return prim


_mode_collapse_p = _make_collapse_primitive()


def _expand_transpose(cot, tab, packed_idx, *, layout):
    from jax.interpreters import ad

    if not ad.is_undefined_primal(tab):
        raise NotImplementedError("mode_expand transpose w.r.t. indices")
    single = tab.aval.ndim == 1
    c = cot[..., None] if single else cot
    if layout.kind == "rfp2":
        R_cot = _fold_rfp2(c, layout, batched=True)
    else:
        R_cot = c
    B = R_cot.shape[-1]
    if single:
        out = _mode_collapse_p.bind(
            R_cot[..., 0].reshape(-1), packed_idx, layout=layout
        )
    else:
        out = _mode_collapse_p.bind(
            R_cot.reshape(-1, B), packed_idx, layout=layout
        )
    return out, None


def _expand_batch(args, dims, *, layout):
    tab, packed_idx = args
    dt, di = dims
    from functools import partial

    from jax.interpreters import batching

    ax = lambda d: None if d is batching.not_mapped else d
    if di is not batching.not_mapped:
        # a batched index table only arises when the model pytree itself is
        # vmapped (its static-in-spirit tables ride as dynamic leaves);
        # vmap the plain-JAX impl — correct, at default-gather speed
        out = jax.vmap(
            partial(_expand_impl, layout=layout), in_axes=(ax(dt), di)
        )(tab, packed_idx)
        return out, 0
    if tab.ndim - (0 if dt is batching.not_mapped else 1) != 1:
        # nested batching: peel one level through the vmapped impl
        out = jax.vmap(
            partial(_expand_impl, layout=layout), in_axes=(dt, None)
        )(tab, packed_idx)
        return out, 0
    # ride the batch as extra gather-slice columns
    t = jnp.moveaxis(tab, dt, -1)  # (U, B)
    out = mode_expand(t, packed_idx, layout)  # core + (B,)
    return out, out.ndim - 1


def _make_primitive():
    from jax.extend.core import Primitive
    from jax.interpreters import ad, batching, mlir

    prim = Primitive("nifty_mode_expand")
    prim.def_impl(lambda tab, idx, *, layout: _expand_impl(tab, idx, layout=layout))
    prim.def_abstract_eval(_expand_abstract)
    ad.defjvp(prim, lambda dt, tab, idx, *, layout: mode_expand_raw(dt, idx, layout), None)
    ad.primitive_transposes[prim] = _expand_transpose
    batching.primitive_batchers[prim] = _expand_batch
    mlir.register_lowering(
        prim,
        mlir.lower_fun(
            lambda tab, idx, *, layout: _expand_impl(tab, idx, layout=layout),
            multiple_results=False,
        ),
    )
    return prim


_mode_expand_p = _make_primitive()


def mode_expand_raw(tab, packed_idx, layout):
    return _mode_expand_p.bind(tab, packed_idx, layout=layout)


def mode_expand(tab, packed_idx, layout):
    """Expand per-unique-mode values ``tab`` onto the core harmonic grid.

    ``tab``: (n_unique,) values (or (n_unique, B) column-batched).
    ``packed_idx``/``layout``: from :func:`build_expand_layout`.
    Returns an array of ``layout.core_shape`` (plus trailing batch dim).
    Exactly equal to ``tab[core_idx]``; the transpose is a single packed
    scatter-add (segment sum over the mode bins).
    """
    return _mode_expand_p.bind(
        jnp.asarray(tab), packed_idx, layout=layout
    )
