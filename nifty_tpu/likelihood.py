"""Likelihood core: energies with Fisher metrics and their square roots.

A :class:`Likelihood` is an energy (negative log-likelihood) together with

* ``transformation`` — the coordinate map into a space where the
  likelihood metric is Euclidean,
* ``left_sqrt_metric``  (LSM)  = pullback (vjp) of ``transformation``,
* ``right_sqrt_metric`` (RSM)  = pushforward (jvp) of ``transformation``
  (the linear transpose of the LSM),
* ``metric`` = LSM ∘ RSM — the Fisher information metric.

All derived quantities are obtained with JAX's jvp / vjp /
``linear_transpose`` — there are no hand-written Jacobians anywhere.  The
metric-vector product (one linearized forward + one transposed
application of the full model) is the hot loop of variational inference;
everything here stays inside ``jit`` without host round-trips.

Behavioral parity with ``nifty/re/likelihood.py:191-757``; independent
implementation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Tuple

import jax
from jax import numpy as jnp
from jax.tree_util import Partial, tree_leaves, tree_map, tree_structure

from .model import ChainModel, Initializer, LazyModel, Model, NoValue
from .utils.tree import (
    ShapeWithDtype,
    Vector,
    conj,
    shape_dtype_struct,
    zeros_like,
)

__all__ = [
    "Likelihood",
    "LikelihoodPartial",
    "LikelihoodSum",
    "LikelihoodWithModel",
    "StandardHamiltonian",
    "partial_insert_and_remove",
]


def _functional_conj(fun):
    """Wrap a linear(ized) function so inputs/outputs are conjugated.

    vjp computes the adjoint of the complex-linearized map; for metric
    algebra we need the transposed map acting on (real-structured)
    cotangents, hence the double conjugation.  No-op for real pytrees.
    """

    def conjugated(*args, **kwargs):
        return conj(fun(*tree_map(jnp.conj, args), **kwargs))

    return conjugated


def _parse_point_estimates(point_estimates, primals):
    """Split `primals` into liquid (inferred) and frozen (point-estimated).

    `point_estimates` may be a tuple of key names (for dict-like primals) or
    a boolean pytree congruent with `primals` (True = frozen).

    Returns ``(insert_axes, primals_liquid, primals_frozen)`` where
    `insert_axes` is the boolean tree, and the liquid/frozen parts are
    given as a Vector and a tuple of leaves respectively.
    """
    if isinstance(point_estimates, (tuple, list)):
        if not point_estimates:
            return None, primals, None
        p_tree = primals.tree if isinstance(primals, Vector) else primals
        if not isinstance(p_tree, dict):
            raise TypeError("string point-estimates need dict-like primals")
        insert_axes = {k: k in point_estimates for k in p_tree}
        if sum(insert_axes.values()) != len(point_estimates):
            missing = set(point_estimates) - set(p_tree)
            raise ValueError(f"point estimates {missing} not in primals")
        insert_axes = tree_map(
            lambda v, p: tree_map(lambda _: v, p), insert_axes, p_tree
        )
        insert_axes = Vector(insert_axes) if isinstance(primals, Vector) else insert_axes
    else:
        insert_axes = point_estimates
    if tree_structure(insert_axes) != tree_structure(primals):
        raise ValueError("point-estimate structure does not match primals")
    flat = tree_leaves(primals)
    flags = tree_leaves(insert_axes)
    frozen = tuple(p for p, f in zip(flat, flags) if f)
    liquid = tuple(p for p, f in zip(flat, flags) if not f)
    return insert_axes, Vector(liquid), frozen


def _partial_argument(call, insert_axes, flat_fill):
    """Fix a subset of leaves of selected arguments of `call`.

    For each argument with a non-None entry in `insert_axes` (a boolean
    pytree), the leaves flagged True are taken from `flat_fill` and the
    remaining leaves from the (flattened) runtime argument.
    """
    if not any(insert_axes):
        return call

    axes_metas = []
    for axes, fill in zip(insert_axes, flat_fill):
        if axes is None:
            axes_metas.append(None)
            continue
        flags = tree_leaves(axes)
        struct = tree_structure(axes)
        axes_metas.append((flags, struct, fill))

    def inserted(*args):
        full_args = []
        for arg, meta in zip(args, axes_metas):
            if meta is None:
                full_args.append(arg)
                continue
            flags, struct, fill = meta
            liquid = list(tree_leaves(arg))
            frozen = list(fill)
            merged = [frozen.pop(0) if f else liquid.pop(0) for f in flags]
            full_args.append(jax.tree_util.tree_unflatten(struct, merged))
        return call(*full_args)

    return inserted


def partial_insert_and_remove(
    call, insert_axes, flat_fill, *, remove_axes=(), unflatten=None
):
    """Insert `flat_fill` into `call`'s arguments at `insert_axes` and
    optionally strip `remove_axes` leaves from its output.

    Reference: ``nifty/re/likelihood.py:119``.
    """
    if insert_axes is not None:
        call = _partial_argument(call, insert_axes=insert_axes, flat_fill=flat_fill)
    if not remove_axes:
        return call
    flags = tree_leaves(remove_axes)

    def removed(*args):
        out = call(*args)
        leaves = tree_leaves(out)
        kept = tuple(x for x, f in zip(leaves, flags) if not f)
        return unflatten(kept) if unflatten is not None else kept

    return removed


def _parse_lsm_shape(shape):
    leaves = tree_leaves(shape)
    if all(hasattr(e, "shape") and hasattr(e, "dtype") for e in leaves) and leaves:
        return shape
    return ShapeWithDtype(shape)


class Likelihood(LazyModel):
    """Negative log-likelihood with metric algebra.

    Subclasses implement at least ``energy``; ``transformation`` (when
    available) yields LSM/RSM/metric for free via autodiff.
    """

    _lsm_tan_shp: Any = dataclasses.field(default=None)

    def __init__(self, *, domain=NoValue, init=NoValue, lsm_tangents_shape=None):
        self._lsm_tan_shp = _parse_lsm_shape(lsm_tangents_shape)
        super().__init__(domain=domain, init=init)

    def __call__(self, primals, **kw):
        return self.energy(primals, **kw)

    def energy(self, primals, **kw):
        raise NotImplementedError("`energy` is not implemented")

    def normalized_residual(self, primals, **kw):
        raise NotImplementedError("`normalized_residual` is not implemented")

    def transformation(self, primals, **kw):
        raise NotImplementedError("`transformation` is not implemented")

    def metric(self, primals, tangents, **kw):
        """Fisher metric applied to `tangents` at `primals` (= LSM∘RSM)."""
        return self.left_sqrt_metric(
            primals, self.right_sqrt_metric(primals, tangents, **kw), **kw
        )

    def left_sqrt_metric(self, primals, tangents, **kw):
        """Pullback of data-space tangents: vjp of `transformation`."""
        _, bwd = jax.vjp(Partial(self.transformation, **kw), primals)
        return _functional_conj(bwd)(tangents)[0]

    def right_sqrt_metric(self, primals, tangents, **kw):
        """Pushforward of parameter tangents: transpose of the LSM."""
        lsm = Partial(self.left_sqrt_metric, primals, **kw)
        rsm = jax.linear_transpose(lsm, self.left_sqrt_metric_tangents_shape)
        return _functional_conj(rsm)(tangents)[0]

    @property
    def left_sqrt_metric_tangents_shape(self):
        return self._lsm_tan_shp

    @property
    def lsm_tangents_shape(self):
        return self._lsm_tan_shp

    @property
    def right_sqrt_metric_tangents_shape(self):
        return self.domain

    @property
    def rsm_tangents_shape(self):
        return self.domain

    def amend(self, f: Callable, /, *, domain=NoValue, likelihood_argnames=None):
        """Compose a forward model to the right of the likelihood."""
        return LikelihoodWithModel(
            self, f, domain=domain, likelihood_argnames=likelihood_argnames
        )

    def __add__(self, other):
        return LikelihoodSum(self, other)

    def freeze(self, *, primals, point_estimates):
        """Partially insert `primals`, freezing the point-estimated leaves."""
        if not point_estimates:
            return self, primals
        lp = LikelihoodPartial(self, primals=primals, point_estimates=point_estimates)
        return lp, lp.splitx(primals)[0]

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class LikelihoodWithModel(Likelihood):
    """Likelihood composed with a forward model `f` (lh ∘ f).

    The metric becomes Jᶠᵀ · M_lh · Jᶠ, computed by a single `jax.linearize`
    plus its transpose (reference: ``nifty/re/likelihood.py:546-633``).
    """

    likelihood: Likelihood = dataclasses.field(metadata=dict(static=False))
    forward: Callable = dataclasses.field(metadata=dict(static=False))
    likelihood_argnames: Tuple = ()

    def __init__(
        self,
        likelihood: Likelihood,
        f: Callable,
        /,
        *,
        domain=NoValue,
        init=NoValue,
        likelihood_argnames=None,
    ):
        self.likelihood = likelihood
        if not callable(f):
            raise TypeError(f"forward model must be callable; got {f!r}")
        self.forward = f if isinstance(f, LazyModel) else Partial(f)
        likelihood_argnames = () if likelihood_argnames is None else likelihood_argnames
        if not isinstance(likelihood_argnames, (tuple, list)):
            raise TypeError(f"invalid likelihood_argnames {likelihood_argnames!r}")
        self.likelihood_argnames = tuple(likelihood_argnames)
        if domain is NoValue and isinstance(f, LazyModel):
            domain = f.domain
        if init is NoValue and isinstance(f, LazyModel):
            init = f.init
        super().__init__(
            domain=domain, init=init, lsm_tangents_shape=likelihood.lsm_tangents_shape
        )

    def _split_kw(self, **kw):
        left = {k: kw.pop(k) for k in self.likelihood_argnames}
        return left, kw

    def energy(self, primals, **kw):
        kl, kr = self._split_kw(**kw)
        return self.likelihood(self.forward(primals, **kr), **kl)

    def normalized_residual(self, primals, **kw):
        kl, kr = self._split_kw(**kw)
        return self.likelihood.normalized_residual(self.forward(primals, **kr), **kl)

    def transformation(self, primals, **kw):
        kl, kr = self._split_kw(**kw)
        return self.likelihood.transformation(self.forward(primals, **kr), **kl)

    def metric(self, primals, tangents, **kw):
        kl, kr = self._split_kw(**kw)
        # One linearization of the forward model serves both the push-forward
        # and (via transpose) the pull-back — cheaper than a second vjp.
        y, fwd = jax.linearize(Partial(self.forward, **kr), primals)
        bwd = _functional_conj(jax.linear_transpose(fwd, primals))
        return bwd(self.likelihood.metric(y, fwd(tangents), **kl))[0]

    def left_sqrt_metric(self, primals, tangents, **kw):
        kl, kr = self._split_kw(**kw)
        y, bwd = jax.vjp(Partial(self.forward, **kr), primals)
        bwd = _functional_conj(bwd)
        return bwd(self.likelihood.left_sqrt_metric(y, tangents, **kl))[0]

    def right_sqrt_metric(self, primals, tangents, **kw):
        kl, kr = self._split_kw(**kw)
        y, fwd = jax.linearize(Partial(self.forward, **kr), primals)
        return self.likelihood.right_sqrt_metric(y, fwd(tangents), **kl)

    def amend(self, f: Callable, *, domain=NoValue, likelihood_argnames=None):
        fwd = self.forward

        def chained(x, **kw):
            return fwd(f(x, **kw))

        # ChainModel keeps both sub-models dynamic pytree children so their
        # arrays remain jit parameters (a closure would inline them)
        chained_model = (
            ChainModel(fwd, f) if isinstance(f, LazyModel) else Partial(chained)
        )
        likelihood_argnames = (
            self.likelihood_argnames
            if likelihood_argnames is None
            else likelihood_argnames
        )
        return LikelihoodWithModel(
            self.likelihood,
            chained_model,
            domain=domain,
            likelihood_argnames=likelihood_argnames,
        )

    def __repr__(self):
        return f"{self.likelihood!r}.amend({self.forward!r})"


class LikelihoodSum(Likelihood):
    """Sum of independent likelihoods over a shared parameter domain.

    Data-space trees of the addends are joined under unique keys so the
    LSM/RSM tangent spaces stay disjoint (reference:
    ``nifty/re/likelihood.py:661``).
    """

    likelihood_summands: Tuple = dataclasses.field(metadata=dict(static=False))

    def __init__(self, *likelihood_summands, domain=NoValue, init=NoValue):
        flat = []
        for lh in likelihood_summands:
            if isinstance(lh, LikelihoodSum):
                flat.extend(lh.likelihood_summands)
            elif isinstance(lh, Likelihood):
                flat.append(lh)
            else:
                raise TypeError(f"object of type {type(lh)} is not a Likelihood")
        self.likelihood_summands = tuple(flat)

        joined_tangents = {
            self._key(i): lh.lsm_tangents_shape for i, lh in enumerate(flat)
        }
        if domain is NoValue:
            domain = {}
            for lh in flat:
                d = lh.domain
                if d is NoValue or d is None:
                    domain = NoValue
                    break
                d = d.tree if isinstance(d, Vector) else d
                domain = {**domain, **d}
        if init is NoValue:
            inits = [lh._init for lh in flat if lh._init is not NoValue]
            if len(inits) == len(flat):
                from functools import reduce

                init = reduce(lambda a, b: a | b, inits)
        super().__init__(domain=domain, init=init, lsm_tangents_shape=joined_tangents)

    @staticmethod
    def _key(index):
        return f"lh_{index}"

    def energy(self, primals, **kw):
        return sum(lh.energy(primals, **kw) for lh in self.likelihood_summands)

    def normalized_residual(self, primals, **kw):
        return {
            self._key(i): lh.normalized_residual(primals, **kw)
            for i, lh in enumerate(self.likelihood_summands)
        }

    def transformation(self, primals, **kw):
        return {
            self._key(i): lh.transformation(primals, **kw)
            for i, lh in enumerate(self.likelihood_summands)
        }

    def metric(self, primals, tangents, **kw):
        from .utils.tree import sum_of

        return sum_of(
            [lh.metric(primals, tangents, **kw) for lh in self.likelihood_summands]
        )

    def left_sqrt_metric(self, primals, tangents, **kw):
        from .utils.tree import sum_of

        return sum_of(
            [
                lh.left_sqrt_metric(primals, tangents[self._key(i)], **kw)
                for i, lh in enumerate(self.likelihood_summands)
            ]
        )

    def right_sqrt_metric(self, primals, tangents, **kw):
        return {
            self._key(i): lh.right_sqrt_metric(primals, tangents, **kw)
            for i, lh in enumerate(self.likelihood_summands)
        }

    def __repr__(self):
        return " + ".join(repr(lh) for lh in self.likelihood_summands)


class LikelihoodPartial(Likelihood):
    """Likelihood with a frozen (point-estimated) subset of its primals.

    The frozen leaves are inserted into every call; tangents for them are
    zero and are stripped from outputs (reference:
    ``nifty/re/likelihood.py:399``).
    """

    likelihood: Likelihood = dataclasses.field(metadata=dict(static=False))
    primals_frozen: Any = dataclasses.field(metadata=dict(static=False))

    def __init__(self, likelihood, /, *, primals, point_estimates):
        self.likelihood = likelihood
        self.point_estimates = point_estimates
        self.insert_axes, p_liquid, self.primals_frozen = _parse_point_estimates(
            point_estimates, primals
        )
        super().__init__(
            domain=tree_map(ShapeWithDtype.from_leave, p_liquid),
            lsm_tangents_shape=likelihood.lsm_tangents_shape,
        )

    @property
    def unflatten(self):
        return Vector

    @property
    def energy(self):
        return partial_insert_and_remove(
            self.likelihood.energy,
            insert_axes=(self.insert_axes,),
            flat_fill=(self.primals_frozen,),
        )

    @property
    def transformation(self):
        return partial_insert_and_remove(
            self.likelihood.transformation,
            insert_axes=(self.insert_axes,),
            flat_fill=(self.primals_frozen,),
        )

    @property
    def normalized_residual(self):
        return partial_insert_and_remove(
            self.likelihood.normalized_residual,
            insert_axes=(self.insert_axes,),
            flat_fill=(self.primals_frozen,),
        )

    @property
    def left_sqrt_metric(self):
        return partial_insert_and_remove(
            self.likelihood.left_sqrt_metric,
            insert_axes=(self.insert_axes, None),
            flat_fill=(self.primals_frozen, None),
            remove_axes=self.insert_axes,
            unflatten=self.unflatten,
        )

    @property
    def right_sqrt_metric(self):
        return partial_insert_and_remove(
            self.likelihood.right_sqrt_metric,
            insert_axes=(self.insert_axes, self.insert_axes),
            flat_fill=(self.primals_frozen, zeros_like(self.primals_frozen)),
        )

    @property
    def metric(self):
        return partial_insert_and_remove(
            self.likelihood.metric,
            insert_axes=(self.insert_axes, self.insert_axes),
            flat_fill=(self.primals_frozen, zeros_like(self.primals_frozen)),
            remove_axes=self.insert_axes,
            unflatten=self.unflatten,
        )

    def splitx(self, primals):
        """Split `primals` into (liquid, frozen)."""
        return _parse_point_estimates(self.point_estimates, primals)[1:]

    def __repr__(self):
        return (
            f"{self.__class__.__name__}({self.likelihood!r},"
            f" point_estimates={self.point_estimates!r})"
        )


class StandardHamiltonian(LazyModel):
    """Likelihood plus standard-normal prior: H(ξ) = lh(ξ) + ½‖ξ‖².

    Its metric is the likelihood metric plus the identity (reference:
    ``nifty/re/optimize_kl.py:67``).
    """

    likelihood: Likelihood = dataclasses.field(metadata=dict(static=False))

    def __init__(self, likelihood: Likelihood, /):
        self.likelihood = likelihood

    def __call__(self, primals, **kw):
        return self.energy(primals, **kw)

    def energy(self, primals, **kw):
        from .utils.tree import vdot

        return self.likelihood(primals, **kw) + 0.5 * jnp.real(vdot(primals, primals))

    def metric(self, primals, tangents, **kw):
        lhm = self.likelihood.metric(primals, tangents, **kw)
        return tree_map(jnp.add, lhm, tangents)
