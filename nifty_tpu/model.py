"""Generative-model core: pytree-registered dataclass models.

Every model subclass is automatically turned into a dataclass and
registered as a JAX pytree whose fields are *static* (compile-time
constants hashed into the jit cache) unless explicitly marked dynamic via
``dataclasses.field(metadata=dict(static=False))``.  This lets whole
models — including likelihoods holding data arrays — be passed as
arguments into ``jit``-ed functions instead of being baked into the
compiled executable as constants, where inlined mega-constants blow up
compile time and device memory.

Behavioral parity with the reference's model core
(``nifty/re/model.py:32-477``); independent implementation.
"""

from __future__ import annotations

import abc
import dataclasses
from functools import partial
from typing import Any, Callable, Iterable, Optional
from warnings import warn

import jax
from jax import eval_shape, random, vmap
from jax import numpy as jnp
from jax.tree_util import (
    register_pytree_node,
    tree_leaves,
    tree_map,
    tree_structure,
    tree_unflatten,
)

from .utils.misc import wrap
from .utils.pytree_string import PyTreeString
from .utils.tree import ShapeWithDtype, Vector, random_like

__all__ = [
    "ChainModel",
    "ClipModel",
    "Initializer",
    "LazyModel",
    "Model",
    "ModelMeta",
    "NoValue",
    "VModel",
    "WrappedCall",
]


class _NoValueT:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NoValue"

    def __bool__(self):
        return False


NoValue = _NoValueT()


class Initializer:
    """Composable pytree of per-parameter initialization callables.

    Calling an Initializer with a PRNG key splits the key once per leaf and
    invokes each leaf's callable with its subkey (reference:
    ``nifty/re/model.py:32``).  Two initializers over dict-structures can be
    merged with ``|``.
    """

    domain = ShapeWithDtype((2,), jnp.uint32)

    def __init__(self, call_or_struct):
        if isinstance(call_or_struct, Initializer):
            call_or_struct = call_or_struct._call_or_struct
        self._call_or_struct = call_or_struct

    @property
    def stupid(self) -> bool:
        """True when holding a single opaque callable rather than a struct."""
        return callable(self._call_or_struct)

    def __call__(self, key, *args, **kwargs):
        if self.stupid:
            return self._call_or_struct(key, *args, **kwargs)
        struct = tree_structure(self._call_or_struct)
        subkeys = tree_unflatten(struct, list(random.split(key, struct.num_leaves)))
        return tree_map(
            lambda init, k: init(k, *args, **kwargs), self._call_or_struct, subkeys
        )

    @property
    def target(self):
        return eval_shape(self, Initializer.domain)

    def __or__(self, other):
        other = other if isinstance(other, Initializer) else Initializer(other)
        if self.stupid or other.stupid:
            return NotImplemented
        return Initializer({**self._call_or_struct, **other._call_or_struct})

    def __getitem__(self, key):
        if self.stupid:
            raise NotImplementedError("opaque initializer is not indexable")
        return Initializer(self._call_or_struct[key])

    def __len__(self):
        return len(self._call_or_struct if not self.stupid else self.target)

    def __repr__(self):
        return f"Initializer({self._call_or_struct!r})"


class ModelMeta(abc.ABCMeta):
    """Metaclass turning model classes into pytree-registered dataclasses.

    Flattening rule: instance attributes whose dataclass field carries
    ``metadata={'static': False}`` become pytree children; everything else
    is aux data (static).  Attribute names of children ride along as
    :class:`PyTreeString` so they survive transformations.
    """

    def __new__(mcs, name, bases, namespace, /, **kwargs):
        cls = super().__new__(mcs, name, bases, namespace, **kwargs)
        cls = dataclasses.dataclass(init=False, repr=False, eq=False)(cls)

        def flatten(obj):
            children, aux = [], []
            fields = obj.__dataclass_fields__
            for key, val in obj.__dict__.items():
                meta = fields[key].metadata if key in fields else {}
                if meta.get("static", True) is False:
                    children.append((PyTreeString(key), val))
                else:
                    aux.append((key, val))
            return tuple(children), tuple(aux)

        def unflatten(aux, children, *, _cls=cls):
            obj = object.__new__(_cls)
            for key, val in tuple(children) + tuple(aux):
                object.__setattr__(obj, str(key), val)
            return obj

        register_pytree_node(cls, flatten, unflatten)
        return cls


class LazyModel(metaclass=ModelMeta):
    """Base class deriving `domain`, `target`, and `init` lazily.

    * `domain` falls back to `eval_shape` of `init`,
    * `target` falls back to `eval_shape` of `__call__` over `domain`,
    * `init` falls back to white-normal initialization over `domain`.

    Reference: ``nifty/re/model.py:146``.
    """

    _domain: Any = dataclasses.field(default=NoValue)
    _target: Any = dataclasses.field(default=NoValue)
    _init: Any = dataclasses.field(default=NoValue)

    def __init__(self, domain=NoValue, target=NoValue, init=NoValue):
        self._domain = domain
        self._target = target
        self._init = Initializer(init) if init is not NoValue else NoValue

    def __call__(self, *args, **kwargs):
        raise NotImplementedError()

    @property
    def domain(self):
        if self._domain is NoValue and self._init is not NoValue:
            return eval_shape(self.init, Initializer.domain)
        return self._domain

    @property
    def target(self):
        if self._target in (NoValue, None) and self.domain is not NoValue:
            return eval_shape(self.__call__, self.domain)
        return self._target

    @property
    def init(self) -> Initializer:
        if self._init is NoValue:
            warn(
                "no initializer set; drawing white standard-normal parameters"
                " over the model domain"
            )
            return Initializer(
                tree_map(lambda p: partial(random_like, primals=p), self.domain)
            )
        return self._init


class Model(LazyModel):
    """Join a callable with a domain and an initializer.

    Reference: ``nifty/re/model.py:197``.
    """

    def __init__(
        self,
        call: Optional[Callable] = None,
        *,
        domain=NoValue,
        target=NoValue,
        init=NoValue,
        white_init: bool = False,
    ):
        self._call = call
        if init is NoValue and domain is not NoValue and white_init:
            init = tree_map(lambda p: partial(random_like, primals=p), domain)
        elif init is NoValue and domain is NoValue:
            raise ValueError("one of `init` or `domain` must be set")
        if domain is NoValue and init is not NoValue:
            domain = eval_shape(Initializer(init), Initializer.domain)
        if target is NoValue and domain is not NoValue:
            # Pre-populate attributes so an overloaded __call__ may reference
            # them during the eval_shape below.
            self._domain, self._target, self._init = domain, None, NoValue
            target = eval_shape(self, domain)
        super().__init__(domain=domain, target=target, init=init)

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def __repr__(self):
        return f"{self.__class__.__name__}(domain={self._domain!r})"


class WrappedCall(Model):
    """Model applying `call` to the entry `input[name]` of a dict input.

    Reference: ``nifty/re/model.py:299``.
    """

    def __init__(
        self,
        call: Callable,
        *,
        name=None,
        shape=(),
        dtype=None,
        white_init: bool = False,
        target=NoValue,
    ):
        leaves = tree_leaves(shape)
        is_swd = len(leaves) > 0 and all(
            hasattr(e, "shape") and hasattr(e, "dtype") for e in leaves
        )
        domain = shape if is_swd else ShapeWithDtype(shape, dtype)
        if name is not None:
            call = wrap(call, name=name)
            domain = {name: domain}
        super().__init__(call, domain=domain, target=target, white_init=white_init)


class ChainModel(Model):
    """Compose ``outer`` after an ``inner`` model, keeping both as *dynamic*
    pytree children.

    Use this instead of closing over a sub-model in a plain function: a
    closure hides the sub-model's arrays in the static treedef, so when the
    composed model is threaded through ``jit`` they are inlined into the
    compiled program as constants.  For large models (e.g. a big correlated
    field's power distributor) that bloats the HLO by hundreds of MB.  As
    dynamic children they stay runtime parameters.

    ``outer`` may be any callable (wrapped in ``jax.tree_util.Partial`` if
    not already a pytree) or another model.
    """

    outer: Any = dataclasses.field(metadata=dict(static=False), default=None)
    inner: Any = dataclasses.field(metadata=dict(static=False), default=None)

    def __init__(self, outer, inner, *, domain=NoValue, init=NoValue, target=NoValue):
        from jax.tree_util import Partial

        self.outer = (
            outer
            if isinstance(outer, (LazyModel, Partial))
            else Partial(outer)
        )
        self.inner = inner
        if isinstance(inner, LazyModel):
            domain = inner.domain if domain is NoValue else domain
            if init is NoValue and inner._init is not NoValue:
                init = inner.init
        super().__init__(domain=domain, init=init, target=target)

    def __call__(self, x, **kw):
        return self.outer(self.inner(x, **kw))

    def __repr__(self):
        return f"ChainModel({self.outer!r}, {self.inner!r})"


class RematModel(Model):
    """Rematerialize the wrapped model under AD (``jax.checkpoint``).

    Inside ``jvp``/``vjp`` — i.e. on the Fisher-metric hot path — the
    model's intermediates (FFT stages, amplitude expansions) are
    recomputed during the backward pass instead of kept live, trading
    ~1 extra forward evaluation for a several-fold cut in peak memory.
    Use for ≥10⁸-dof fields where the metric's residuals dominate HBM.
    """

    inner: Any = dataclasses.field(metadata=dict(static=False), default=None)

    def __init__(self, inner):
        self.inner = inner
        # mirror ChainModel: only adopt the inner initializer when one is
        # actually set, so LazyModel's lazy fallback applies otherwise
        init = (
            inner.init
            if isinstance(inner, LazyModel) and inner._init is not NoValue
            else NoValue
        )
        super().__init__(domain=inner.domain, init=init)

    def __call__(self, x, **kw):
        import jax

        return jax.checkpoint(lambda m, y: m(y, **kw))(self.inner, x)

    def __repr__(self):
        return f"RematModel({self.inner!r})"


def _is_int_or_none(x):
    return x is None or isinstance(x, int)


def _parse_axes(axes, domain, what=""):
    struct = tree_structure(domain)
    if isinstance(axes, int):
        return tree_unflatten(struct, (axes,) * struct.num_leaves)
    if isinstance(axes, str):
        axes = (axes,)
    if isinstance(axes, Iterable) and all(isinstance(a, str) for a in axes):
        dom = dict(domain)
        return {k: (0 if k in axes else None) for k in dom}
    if tree_structure(axes, is_leaf=_is_int_or_none) != struct:
        raise ValueError(f"{what} axes structure does not match the domain")
    return axes


class VModel(LazyModel):
    """Vectorized model: maps `model` over a new leading axis of size
    `axis_size` with batched initialization (reference: ``nifty/re/model.py:370``).
    """

    model: LazyModel = dataclasses.field(metadata=dict(static=False))
    in_axes: Any = dataclasses.field(default=0)
    out_axes: Any = dataclasses.field(default=0)
    axis_size: int = dataclasses.field(default=1)

    def __init__(self, model, axis_size: int, in_axes=0, out_axes=0):
        if not isinstance(model, LazyModel):
            raise ValueError(f"model {model!r} of invalid type")
        if model.init.stupid:
            raise ValueError("can only vmap models with a structured init")
        if not isinstance(axis_size, int) or axis_size <= 0:
            raise ValueError(f"invalid axis_size {axis_size!r}")
        self.model = model
        self.axis_size = axis_size
        self.in_axes = _parse_axes(in_axes, model.domain, "domain")
        self.out_axes = _parse_axes(out_axes, model.target, "target")

        def batched(func, axes):
            def _init(key):
                keys = random.split(key, axis_size)
                return vmap(func, out_axes=axes)(keys)

            return _init

        init_struct = model.init._call_or_struct
        axes_or_skip = tree_map(
            lambda a: NoValue if a is None else a, self.in_axes, is_leaf=_is_int_or_none
        )
        init = tree_map(
            lambda f, a: f if a is NoValue else batched(f, a),
            init_struct,
            axes_or_skip,
        )
        super().__init__(init=init)

    def __call__(self, x):
        axes = self.in_axes
        axes_t = axes.tree if isinstance(axes, Vector) else axes
        x_t = x.tree if isinstance(x, Vector) else x
        if isinstance(axes_t, dict) and isinstance(x_t, dict):
            axes_t = {**axes_t, **{k: None for k in set(x_t) - set(axes_t)}}
        axes = Vector(axes_t) if isinstance(x, Vector) else axes_t
        return vmap(self.model, (axes,), self.out_axes)(x)


class ClipModel(LazyModel):
    """Clip all latent inputs before evaluating the wrapped model — a guard
    against line-search/latent blowups (mostly a debugging aid; reference:
    ``nifty/re/model.py:414``).

    ``custom_clip_func`` replaces the elementwise ``jnp.clip`` on each
    leaf; ``warn=True`` emits a host-side warning (via ``jax.debug``)
    whenever any input exceeds `threshold` in magnitude.
    """

    model: Any = dataclasses.field(metadata=dict(static=False), default=None)

    def __init__(
        self,
        model,
        threshold: float = 10.0,
        warn: bool = False,
        custom_clip_func: Optional[Callable] = None,
    ):
        self.model = model
        self.threshold = float(threshold)
        self.warn = bool(warn)
        self._custom_clip = custom_clip_func
        super().__init__(init=model.init)

    def _clip(self, leaf):
        if self._custom_clip is not None:
            return self._custom_clip(leaf)
        return jnp.clip(leaf, -self.threshold, self.threshold)

    def __call__(self, x):
        if self.warn:
            from jax import debug as jax_debug

            mx = jax.tree_util.tree_reduce(
                jnp.maximum,
                tree_map(lambda l: jnp.max(jnp.abs(l)), x),
                jnp.zeros(()),
            )

            def _warn(m):
                if float(m) > self.threshold:
                    from .logger import logger

                    logger.warning(
                        f"ClipModel: clipping latent inputs (max |x| = {float(m):.3e})"
                    )

            jax_debug.callback(_warn, mx)
        return self.model(tree_map(self._clip, x))
