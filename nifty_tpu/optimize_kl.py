"""MGVI/geoVI variational inference driver (`optimize_kl`).

One VI iteration: (1) draw/refresh approximate posterior samples (CG
inversion of the Hamiltonian metric, optionally nonlinearly curved), then
(2) minimize the sample-averaged KL over the latent mean with Newton-CG.

Defaults:

* the sample axis maps with ``vmap`` on one chip and shards over a 1-D
  device mesh when ``devices=`` is given — the KL mean-reduce then lowers
  to a ``psum``,
* sampling/minimization use the ``lax.while_loop`` CG/Newton-CG, so each
  phase is a single XLA program.

Behavioral parity with ``nifty/re/optimize_kl.py``; independent
implementation.
"""

from __future__ import annotations

import inspect
import os
import pickle
from functools import partial
from typing import Any, Callable, Literal, NamedTuple, Optional, Union

import jax
import numpy as np
from jax import numpy as jnp
from jax import random
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from jax.tree_util import Partial, tree_map

from . import conjugate_gradient, optimize
from .evi import (
    Samples,
    concatenate_zip,
    draw_linear_residual,
    nonlinearly_update_residual,
)
from .likelihood import (
    Likelihood,
    StandardHamiltonian,
    _parse_point_estimates,
    partial_insert_and_remove,
)
from .logger import logger
from .minisanity import minisanity, reduced_residual_stats
from .utils.pytree_string import hide_strings
from .utils.tree import Vector, get_map, vdot, zeros_like

__all__ = ["OptimizeVI", "OptimizeVIState", "optimize_kl"]

_reduce = partial(tree_map, partial(jnp.mean, axis=0))

SMPL_MODE_TYP = Literal[
    "linear_sample",
    "linear_resample",
    "nonlinear_sample",
    "nonlinear_resample",
    "nonlinear_update",
]


def _kl_vg(likelihood, primals, primals_samples, *, map="vmap", reduce=_reduce):
    """Sample-mean KL value and gradient at `primals`."""
    map = get_map(map)
    ham = StandardHamiltonian(likelihood)
    if len(primals_samples) == 0:
        return jax.value_and_grad(ham)(primals)
    vvg = map(jax.value_and_grad(ham))
    return reduce(vvg(primals_samples.at(primals).samples))


def _kl_met(
    likelihood, primals, tangents, primals_samples, *, map="vmap", reduce=_reduce
):
    """Sample-mean Hamiltonian metric applied to `tangents`."""
    map = get_map(map)
    ham = StandardHamiltonian(likelihood)
    if len(primals_samples) == 0:
        return ham.metric(primals, tangents)
    vmet = map(ham.metric, in_axes=(0, None))
    return reduce(vmet(primals_samples.at(primals).samples, tangents))


class OptimizeVIState(NamedTuple):
    nit: int
    key: Any
    sample_state: Optional[Any] = None
    minimization_state: Optional[Any] = None
    config: dict = {}


def _getitem_at_nit(config, key, nit):
    c = config[key]
    if callable(c) and len(inspect.getfullargspec(c).args) == 1:
        return c(nit)
    return c


def _replicate_if_multihost(tree):
    """Multi-host runs shard samples across processes; host-side
    diagnostics (minisanity) need the values fully addressable, so
    all-gather them first (a collective — every process must call this)."""
    leaves = jax.tree_util.tree_leaves(tree)
    bad = [
        l
        for l in leaves
        if hasattr(l, "is_fully_addressable") and not l.is_fully_addressable
    ]
    if not bad:
        return tree
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = bad[0].sharding.mesh
    rep = NamedSharding(mesh, PartitionSpec())
    gathered = jax.jit(lambda xs: xs, out_shardings=[rep] * len(bad))(bad)
    table = {id(b): g for b, g in zip(bad, gathered)}
    return jax.tree_util.tree_map(lambda l: table.get(id(l), l), tree)


def get_status_message(samples, state, residual=None, *, name="", map="vmap") -> str:
    samples = _replicate_if_multihost(samples)
    state = _replicate_if_multihost(state)
    energy = state.minimization_state.fun
    msg_smpl = ""
    if isinstance(state.sample_state, optimize.OptimizeResults):
        nlsi = tuple(int(el) for el in jnp.atleast_1d(state.sample_state.nit))
        msg_smpl = f"\n{name}: #(nonlinear sampling steps) {nlsi}"
    elif state.sample_state is not None and hasattr(state.sample_state, "shape"):
        nlsi = tuple(int(el) for el in jnp.atleast_1d(state.sample_state))
        msg_smpl = f"\n{name}: linear sampling status {nlsi}"
    mini_res = ""
    if residual is not None:
        _, mini_res = minisanity(samples, residual, map=map)
    _, mini_pr = minisanity(samples, map=map)
    return (
        f"{name}: Iteration {state.nit:04d} E:{float(energy):+2.4e}"
        f"{msg_smpl}"
        f"\n{name}: #(KL minimization steps) {int(state.minimization_state.nit)}"
        f"\n{name}: Likelihood residual(s):\n{mini_res}"
        f"\n{name}: Prior residual(s):\n{mini_pr}\n"
    )


class OptimizeVI:
    """Stateless assembly of the MGVI/geoVI update machinery.

    See :func:`optimize_kl` for the one-stop driver.  With ``devices=``,
    samples are placed with a ``NamedSharding`` over a 1-D mesh and every
    KL/metric evaluation runs SPMD with XLA-inserted collectives
    (reference: ``nifty/re/optimize_kl.py:173``).
    """

    def __init__(
        self,
        likelihood: Likelihood,
        n_total_iterations: int,
        *,
        jit: bool = True,
        kl_map="vmap",
        residual_map="vmap",
        kl_reduce=_reduce,
        mirror_samples: bool = True,
        devices: Optional[list] = None,
        position_sharding=None,
        _kl_value_and_grad: Optional[Callable] = None,
        _kl_metric: Optional[Callable] = None,
        _draw_linear_residual: Optional[Callable] = None,
        _nonlinearly_update_residual: Optional[Callable] = None,
        _get_status_message: Optional[Callable] = None,
    ):
        maybe_jit = jax.jit if jit else (lambda f, **k: f)
        residual_map = get_map(residual_map)
        if mirror_samples is False:
            raise NotImplementedError("unmirrored samples are not supported")

        self.named_sharding = None
        self.named_sharding_rep = None
        self.position_sharding = position_sharding
        self.sample_axis_name = None
        if position_sharding is not None:
            if devices is not None:
                raise NotImplementedError(
                    "pass a single mesh with both axes via position_sharding"
                    " (a 'samples' mesh axis is picked up automatically)"
                    " instead of combining devices= with position_sharding="
                )
            # combined sample×field decomposition: if the field mesh also
            # carries a 'samples' axis, the vmapped sample batch is placed
            # on it and GSPMD partitions around the (partial-manual)
            # pencil-FFT shard_map
            leaves = jax.tree_util.tree_leaves(
                position_sharding,
                is_leaf=lambda l: isinstance(l, NamedSharding),
            )
            if leaves and "samples" in leaves[0].mesh.axis_names:
                self.sample_axis_name = "samples"
                self._sample_mesh = leaves[0].mesh
        if devices is not None and len(devices) > 1:
            import numpy as np

            mesh = Mesh(np.asarray(devices), ("samples",))
            self.named_sharding = NamedSharding(mesh, PartitionSpec("samples"))
            self.named_sharding_rep = NamedSharding(mesh, PartitionSpec())

        if _kl_value_and_grad is None:
            _kl_value_and_grad = partial(
                maybe_jit(_kl_vg, static_argnames=("map", "reduce")),
                likelihood,
                map=kl_map,
                reduce=kl_reduce,
            )
        if _kl_metric is None:
            _kl_metric = partial(
                maybe_jit(_kl_met, static_argnames=("map", "reduce")),
                likelihood,
                map=kl_map,
                reduce=kl_reduce,
            )
        # NOTE: the likelihood is *not* partial-bound here — it is threaded
        # as an explicit (pytree) argument through vmap/jit so its data
        # arrays are runtime inputs rather than constants baked into every
        # compiled program.
        if _draw_linear_residual is None:
            _draw_linear_residual = draw_linear_residual
        if _nonlinearly_update_residual is None:
            _nonlinearly_update_residual = nonlinearly_update_residual
        self.likelihood = likelihood
        if _get_status_message is None:
            _get_status_message = partial(
                get_status_message,
                residual=likelihood.normalized_residual,
                name=self.__class__.__name__,
            )

        self.n_total_iterations = n_total_iterations
        self.kl_value_and_grad = _kl_value_and_grad
        self.kl_metric = _kl_metric
        self.draw_linear_residual = _draw_linear_residual
        self.nonlinearly_update_residual = _nonlinearly_update_residual
        self.residual_map = residual_map
        self.get_status_message = _get_status_message
        self._jit = jit
        self._programs = {}

    def _jit_once(self, name, kwargs, mapped):
        """``jit(mapped)``, kept per ``(name, kwargs)`` so that later
        iterations reuse the compiled program.  Unjitted, a mapped sampler
        runs op by op and compiles every primitive on its own."""
        if not self._jit:
            return mapped
        leaves, treedef = jax.tree_util.tree_flatten(kwargs)
        key = (name, treedef, tuple((type(l), l) for l in leaves))
        try:
            return self._programs.setdefault(key, jax.jit(mapped))
        except TypeError:  # an unhashable option: compile for this call only
            return jax.jit(mapped)

    # --- sampling -----------------------------------------------------------

    def draw_linear_samples(self, primals, keys, **kwargs):
        kwargs = hide_strings(kwargs)
        sampler = Partial(self.draw_linear_residual, **kwargs)
        sampler = self.residual_map(sampler, in_axes=(None, None, 0))

        if self.named_sharding is None:
            sampler = self._jit_once("draw_linear", kwargs, sampler)
            if self.position_sharding is not None:
                primals = jax.device_put(primals, self.position_sharding)
            if self.sample_axis_name is not None:
                keys = jax.device_put(
                    keys,
                    NamedSharding(
                        self._sample_mesh, PartitionSpec(self.sample_axis_name)
                    ),
                )
            smpls, states = sampler(self.likelihood, primals, keys)
            # interleave each sample with its mirror
            smpls = concatenate_zip(smpls, tree_map(jnp.negative, smpls))
            return Samples(pos=primals, samples=smpls, keys=keys), states

        # Multi-device path: samples sharded over the mesh, primals
        # replicated; the mirrored counterpart lives on the adjacent device
        # when n_samples == mesh/2.
        ns, ns_rep = self.named_sharding, self.named_sharding_rep
        n_samples = len(keys)
        mesh_size = ns.mesh.size
        special_mirror = n_samples * 2 == mesh_size
        if special_mirror:
            keys = jnp.repeat(keys, 2, axis=0)
        keys = jax.device_put(keys, ns)
        in_shardings = (
            tree_map(lambda _: ns_rep, self.likelihood),
            tree_map(lambda _: ns_rep, primals),
            ns,
        )
        out_shardings = (tree_map(lambda _: ns, primals), ns)
        sampler = jax.jit(sampler, in_shardings=in_shardings, out_shardings=out_shardings)
        smpls, states = sampler(self.likelihood, primals, keys)
        if special_mirror:

            @partial(jax.jit, out_shardings=ns)
            def mirror_odd(s):
                return s.at[1::2].set(-s[1::2])

            smpls = tree_map(mirror_odd, smpls)
            keys = keys[::2]
        else:

            @partial(jax.jit, out_shardings=ns)
            def zip_sharded(*arrays):
                return tree_map(
                    lambda *x: jnp.stack(x, axis=1).reshape((-1,) + x[0].shape[1:]),
                    *arrays,
                )

            smpls = zip_sharded(smpls, tree_map(jnp.negative, smpls))
        return Samples(pos=primals, samples=smpls, keys=keys), states

    def nonlinearly_update_samples(self, samples: Samples, **kwargs):
        kwargs = hide_strings(kwargs)
        assert len(samples.keys) == len(samples) // 2
        metric_sample_key = concatenate_zip(*((samples.keys,) * 2))
        sgn = jnp.ones(len(samples.keys))
        sgn = concatenate_zip(sgn, -sgn)
        curver = Partial(self.nonlinearly_update_residual, **kwargs)
        curver = self.residual_map(curver, in_axes=(None, None, 0, 0, 0))
        if self.named_sharding is not None:
            ns, ns_rep = self.named_sharding, self.named_sharding_rep
            metric_sample_key = jax.device_put(metric_sample_key, ns)
            sgn = jax.device_put(sgn, ns)
            in_sh = (
                tree_map(lambda _: ns_rep, self.likelihood),
                tree_map(lambda _: ns_rep, samples.pos),
                tree_map(lambda _: ns, samples.pos),
                ns,
                ns,
            )
            out_sh = (tree_map(lambda _: ns, samples.pos), ns)
            curver = jax.jit(curver, in_shardings=in_sh, out_shardings=out_sh)
        else:
            curver = self._jit_once("nonlinearly_update", kwargs, curver)
        smpls, states = curver(
            self.likelihood, samples.pos, samples._samples, metric_sample_key, sgn
        )
        return Samples(pos=samples.pos, samples=smpls, keys=samples.keys), states

    def draw_samples(
        self,
        samples: Samples,
        *,
        key,
        sample_mode: str,
        n_samples: int,
        point_estimates,
        draw_linear_kwargs=None,
        nonlinearly_update_kwargs=None,
        **kwargs,
    ):
        draw_linear_kwargs = draw_linear_kwargs or {}
        nonlinearly_update_kwargs = nonlinearly_update_kwargs or {}
        n_keys = 0 if samples.keys is None else len(samples.keys)
        if n_samples == 0:
            sample_mode = ""
        elif n_samples != n_keys and sample_mode.lower() == "nonlinear_update":
            sample_mode = "nonlinear_resample"
        elif n_samples != n_keys and sample_mode.lower().endswith("_sample"):
            sample_mode = sample_mode.replace("_sample", "_resample")

        mode = sample_mode.lower()
        if mode in (
            "linear_resample",
            "linear_sample",
            "nonlinear_resample",
            "nonlinear_sample",
        ):
            k_smpls = samples.keys
            if mode.endswith("_resample"):
                k_smpls = random.split(key, n_samples)
            assert n_samples == len(k_smpls)
            samples, st = self.draw_linear_samples(
                samples.pos,
                k_smpls,
                point_estimates=point_estimates,
                **draw_linear_kwargs,
                **kwargs,
            )
            if mode.startswith("nonlinear"):
                samples, st = self.nonlinearly_update_samples(
                    samples,
                    point_estimates=point_estimates,
                    **nonlinearly_update_kwargs,
                    **kwargs,
                )
        elif mode == "nonlinear_update":
            samples, st = self.nonlinearly_update_samples(
                samples,
                point_estimates=point_estimates,
                **nonlinearly_update_kwargs,
                **kwargs,
            )
        elif mode == "":
            st = 0  # MAP — nothing to draw
        else:
            raise ValueError(f"invalid sample mode {sample_mode!r}")
        return samples, st

    # --- KL minimization ----------------------------------------------------

    def kl_minimize(
        self,
        samples: Samples,
        minimize: Callable = optimize.newton_cg,
        minimize_kwargs=None,
        constants=(),
        **kwargs,
    ) -> optimize.OptimizeResults:
        minimize_kwargs = {} if minimize_kwargs is None else dict(minimize_kwargs)
        fun_and_grad = Partial(self.kl_value_and_grad, primals_samples=samples, **kwargs)
        hessp = Partial(self.kl_metric, primals_samples=samples, **kwargs)
        pl = samples.pos
        if constants:
            insert_axes, pl, primals_frozen = _parse_point_estimates(constants, pl)
            fun_and_grad = partial_insert_and_remove(
                fun_and_grad,
                insert_axes=(insert_axes,),
                flat_fill=(primals_frozen,),
                remove_axes=(False, insert_axes),
                unflatten=lambda x: (x[0], Vector(x[1:])),
            )
            hessp = partial_insert_and_remove(
                hessp,
                insert_axes=(insert_axes, insert_axes),
                flat_fill=(primals_frozen, zeros_like(primals_frozen)),
                remove_axes=insert_axes,
                unflatten=Vector,
            )
        opt_state = minimize(
            None, x0=pl, fun_and_grad=fun_and_grad, hessp=hessp, **minimize_kwargs
        )
        if constants:
            insert = partial_insert_and_remove(
                lambda x: x,
                insert_axes=(insert_axes,),
                flat_fill=(primals_frozen,),
            )
            opt_state = opt_state._replace(
                x=insert(opt_state.x), jac=insert(opt_state.jac)
            )
        return opt_state

    # --- driver -------------------------------------------------------------

    def init_state(
        self,
        key,
        *,
        nit: int = 0,
        n_samples,
        draw_linear_kwargs=None,
        nonlinearly_update_kwargs=None,
        kl_kwargs=None,
        sample_mode="nonlinear_resample",
        point_estimates=(),
        constants=(),
    ) -> OptimizeVIState:
        config = dict(
            n_samples=n_samples,
            sample_mode=sample_mode,
            point_estimates=point_estimates,
            constants=constants,
            draw_linear_kwargs=draw_linear_kwargs or {},
            nonlinearly_update_kwargs=nonlinearly_update_kwargs or {},
            kl_kwargs=kl_kwargs or {},
        )
        return OptimizeVIState(nit, key, config=config)

    def update(
        self, samples: Samples, state: OptimizeVIState, /, **kwargs
    ) -> tuple[Samples, OptimizeVIState]:
        """One VI iteration: draw/update samples, then minimize the KL."""
        assert isinstance(samples, Samples)
        nit, key, config = state.nit, state.key, state.config
        sample_mode = _getitem_at_nit(config, "sample_mode", nit)
        point_estimates = _getitem_at_nit(config, "point_estimates", nit)
        constants = _getitem_at_nit(config, "constants", nit)
        n_samples = _getitem_at_nit(config, "n_samples", nit)
        draw_linear_kwargs = _getitem_at_nit(config, "draw_linear_kwargs", nit)
        nonlinearly_update_kwargs = _getitem_at_nit(
            config, "nonlinearly_update_kwargs", nit
        )
        key, sk = random.split(key, 2)
        samples, st_smpls = self.draw_samples(
            samples,
            key=sk,
            sample_mode=sample_mode,
            point_estimates=point_estimates,
            n_samples=n_samples,
            draw_linear_kwargs=draw_linear_kwargs,
            nonlinearly_update_kwargs=nonlinearly_update_kwargs,
            **kwargs,
        )
        kl_kwargs = dict(_getitem_at_nit(config, "kl_kwargs", nit))
        kl_opt_state = self.kl_minimize(samples, constants=constants, **kl_kwargs, **kwargs)
        samples = samples.at(kl_opt_state.x)
        kl_opt_state = kl_opt_state._replace(x=None, jac=None, hess=None, hess_inv=None)
        state = state._replace(
            nit=nit + 1,
            key=key,
            sample_state=st_smpls,
            minimization_state=kl_opt_state,
        )
        return samples, state

    def run(self, samples, *args, **kwargs):
        state = self.init_state(*args, **kwargs)
        nm = self.__class__.__name__
        for i in range(state.nit, self.n_total_iterations):
            logger.info(f"{nm}: Starting {i + 1:04d}")
            samples, state = self.update(samples, state)
            logger.info(self.get_status_message(samples, state))
        return samples, state


def _plot_history(path, nits, series, *, ylabel, logy=False):
    """One diagnostic line chart per run artifact (gated on matplotlib).

    `series` is a mapping label → list of per-iteration floats."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib-less environment
        return
    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=120)
    for label, vals in series.items():
        ax.plot(nits, vals, marker="o", markersize=3, linewidth=1.2, label=label)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.25)
    if len(series) > 1 or next(iter(series), "") != ylabel:
        ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _export_history(odir, history):
    """Write energy- and minisanity-history plots (reference:
    ``nifty/cl/minimization/optimize_kl.py:528,618``)."""
    nits = history["nit"]
    if len(nits) == 0:
        return
    e = np.asarray(history["energy"], dtype=float)
    shift = {}
    if np.all(np.asarray(e) > 0):
        _plot_history(
            os.path.join(odir, "energy_history.png"),
            nits,
            {"KL energy": e},
            ylabel="KL energy",
            logy=(e.max() / max(e.min(), 1e-30)) > 1e3,
        )
    else:
        _plot_history(
            os.path.join(odir, "energy_history.png"),
            nits,
            {"KL energy": e},
            ylabel="KL energy",
        )
    if history["lh_chisq"]:
        _plot_history(
            os.path.join(odir, "minisanity_history.png"),
            nits,
            {k: v for k, v in history["lh_chisq"].items()},
            ylabel="reduced chi² (likelihood residuals)",
            logy=True,
        )
    if history["prior_chisq"]:
        _plot_history(
            os.path.join(odir, "minisanity_prior_history.png"),
            nits,
            {k: v for k, v in history["prior_chisq"].items()},
            ylabel="reduced chi² (prior residuals)",
            logy=True,
        )


def _export_operator_outputs(odir, export_operators, samples, nit):
    """Posterior mean/std of user operators, one ``.npz`` per operator
    (reference: ``nifty/cl/minimization/optimize_kl.py:500``)."""
    opdir = os.path.join(odir, "operator_outputs")
    os.makedirs(opdir, exist_ok=True)
    for name, op in export_operators.items():
        vals = np.stack([np.asarray(op(s)) for s in samples])
        np.savez(
            os.path.join(opdir, f"{name}_last.npz"),
            mean=vals.mean(axis=0),
            std=vals.std(axis=0),
            nit=nit,
        )


def optimize_kl(
    likelihood: Likelihood,
    position_or_samples,
    *,
    key,
    n_total_iterations: int,
    n_samples,
    point_estimates=(),
    constants=(),
    jit: bool = True,
    kl_map="vmap",
    residual_map="vmap",
    kl_reduce=_reduce,
    mirror_samples: bool = True,
    draw_linear_kwargs=None,
    nonlinearly_update_kwargs=None,
    kl_kwargs=None,
    sample_mode="nonlinear_resample",
    resume: Union[str, bool] = False,
    callback: Optional[Callable] = None,
    odir: Optional[str] = None,
    devices: Optional[list] = None,
    position_sharding=None,
    export_operators: Optional[dict] = None,
    _optimize_vi=None,
    _optimize_vi_state=None,
) -> tuple[Samples, OptimizeVIState]:
    """One-stop MGVI/geoVI driver (reference: ``nifty/re/optimize_kl.py:738``).

    Most configuration arguments may be callables of the iteration index,
    making schedules first-class.  With ``odir`` set, samples+state are
    pickled each iteration (``resume=True`` continues from the last
    checkpoint), ``minisanity.txt`` plus energy-/minisanity-history plots
    are maintained, and ``export_operators={name: callable}`` writes each
    operator's posterior mean/std to ``odir/operator_outputs/<name>_last.npz``.

    Parallel execution: ``devices=[...]`` shards the *sample* axis over a
    1-D mesh (KL reductions become psums).  ``position_sharding=`` (a
    pytree of `NamedSharding`s, e.g. ``model.position_sharding()`` from a
    model finalized with ``field_mesh=``) runs the whole loop
    domain-decomposed over the *field* axis instead — per-device memory
    O(N/p); samples then map with vmap over the sharded model.
    """
    LAST_FILENAME = "last.pkl"
    MINISANITY_FILENAME = "minisanity.txt"

    opt_vi = _optimize_vi
    if opt_vi is None:
        opt_vi = OptimizeVI(
            likelihood,
            n_total_iterations=n_total_iterations,
            jit=jit,
            kl_map=kl_map,
            residual_map=residual_map,
            kl_reduce=kl_reduce,
            mirror_samples=mirror_samples,
            devices=devices,
            position_sharding=position_sharding,
        )

    last_fn = os.path.join(odir, LAST_FILENAME) if odir is not None else None
    resume_fn = resume if isinstance(resume, str) and os.path.isfile(resume) else last_fn
    sanity_fn = os.path.join(odir, MINISANITY_FILENAME) if odir is not None else None

    if isinstance(position_or_samples, Samples):
        samples = position_or_samples
    else:
        samples = Samples(pos=position_or_samples, samples=None, keys=None)
    opt_vi_st = None
    if resume and resume_fn is not None and os.path.isfile(resume_fn):
        with open(resume_fn, "rb") as f:
            samples, opt_vi_st = pickle.load(f)
    if position_sharding is not None:
        # domain-decomposed execution: place the (possibly resumed)
        # position on the field mesh; everything downstream preserves the
        # placement ("computation follows data" + in-model constraints)
        samples = Samples(
            pos=jax.device_put(samples.pos, position_sharding),
            samples=samples._samples,
            keys=samples.keys,
        )

    opt_vi_st_init = opt_vi.init_state(
        key,
        n_samples=n_samples,
        draw_linear_kwargs=draw_linear_kwargs,
        nonlinearly_update_kwargs=nonlinearly_update_kwargs,
        kl_kwargs=kl_kwargs,
        sample_mode=sample_mode,
        point_estimates=point_estimates,
        constants=constants,
    )
    opt_vi_st = _optimize_vi_state if _optimize_vi_state is not None else opt_vi_st
    opt_vi_st = opt_vi_st_init if opt_vi_st is None else opt_vi_st
    if len(opt_vi_st.config) == 0:
        opt_vi_st = opt_vi_st._replace(config=opt_vi_st_init.config)

    if odir:
        os.makedirs(odir, exist_ok=True)
    if not resume and sanity_fn is not None:
        with open(sanity_fn, "w"):
            pass

    nm = "OPTIMIZE_KL"
    history = {"nit": [], "energy": [], "lh_chisq": {}, "prior_chisq": {}}
    for i in range(opt_vi_st.nit, opt_vi.n_total_iterations):
        logger.info(f"{nm}: Starting {i + 1:04d}")
        samples, opt_vi_st = opt_vi.update(samples, opt_vi_st)
        msg = opt_vi.get_status_message(samples, opt_vi_st, name=nm)
        logger.info(msg)
        if sanity_fn is not None:
            with open(sanity_fn, "a") as f:
                f.write("\n" + msg)
        if odir:
            history["nit"].append(i + 1)
            history["energy"].append(
                float(opt_vi_st.minimization_state.fun)
            )
            try:
                lh_stats = reduced_residual_stats(
                    samples, opt_vi.likelihood.normalized_residual
                )
            except Exception:
                lh_stats = None
            pr_stats = reduced_residual_stats(samples)
            for label, stats, slot in (
                ("lh", lh_stats, "lh_chisq"),
                ("prior", pr_stats, "prior_chisq"),
            ):
                if stats is None:
                    continue
                # one series per ChiSqStats leaf-group
                def _walk(tree, prefix=""):
                    if hasattr(tree, "reduced_chisq"):
                        yield prefix or label, float(
                            jnp.atleast_1d(tree.reduced_chisq)[0]
                        )
                        return
                    if isinstance(tree, dict):
                        for k, v in tree.items():
                            yield from _walk(v, f"{prefix}{k}" if not prefix else f"{prefix}/{k}")
                        return
                    if isinstance(tree, (list, tuple)):
                        for j, v in enumerate(tree):
                            yield from _walk(v, f"{prefix}[{j}]")
                        return

                for key_name, val in _walk(stats):
                    history[slot].setdefault(key_name, []).append(val)
            _export_history(odir, history)
            if export_operators:
                _export_operator_outputs(odir, export_operators, samples, i + 1)
        if last_fn is not None:
            with open(last_fn, "wb") as f:
                pickle.dump((samples, opt_vi_st._replace(config={})), f)
        if callback is not None:
            callback(samples, opt_vi_st)
    return samples, opt_vi_st
