"""Profiling sugar: timings, call counting, and XLA cost analysis.

Counterpart of the reference's profiling helpers
(``nifty/cl/sugar.py:606,699,823`` exec_time / operator-tree profiles and
``nifty/cl/operators/counting_operator.py``): instead of timing an eager
operator tree node-by-node, measure the jitted forward/JVP/VJP programs
and read XLA's own cost model (FLOPs, bytes accessed) from the compiled
executable.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import Any, Callable, Mapping, Optional

import jax
import numpy as np
from jax import numpy as jnp

from .logger import logger

__all__ = [
    "CountingCall",
    "card_line",
    "check_device",
    "cost_analysis",
    "enable_compile_cache",
    "exec_time",
    "median_seconds",
]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured by JAX itself and
    nothing else is configured.  Otherwise the cache lives at the fixed
    path ``<repo>/.jax_cache``: the path is part of the cache key, so a
    directory that moves between runs would never hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def check_device(devices, count=None):
    """Refuse anything but GPUs (and, with ``count``, fewer of them);
    return the first device."""
    if len(devices) == 0:
        raise RuntimeError("JAX found no device")
    platforms = {d.platform for d in devices}
    if platforms != {"gpu"}:
        raise RuntimeError(f"no GPU: JAX's devices are on {sorted(platforms)}")
    if count is not None and len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devices)}")
    return devices[0]


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of every card, ``|``-joined."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    r = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return " | ".join(line.strip() for line in r.stdout.strip().splitlines())


def median_seconds(f, *args, n: int = 10) -> float:
    """Median wall time of single calls of ``f``, each ended by
    ``block_until_ready``, after one warm-up call."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def exec_time(fn: Callable, primals, *, n: int = 3, verbose: bool = True):
    """Median wall-times of the jitted forward, JVP, and VJP of `fn`.

    Returns a dict ``{"forward": s, "jvp": s, "vjp": s, "compile": s}``.
    """
    t0 = time.perf_counter()
    fwd = jax.jit(fn)
    out = jax.block_until_ready(fwd(primals))
    compile_s = time.perf_counter() - t0

    res = {"compile": compile_s, "forward": median_seconds(fwd, primals, n=n)}

    jvp = jax.jit(lambda p, t: jax.jvp(fn, (p,), (t,))[1])
    tangent = jax.tree_util.tree_map(jnp.ones_like, primals)
    res["jvp"] = median_seconds(jvp, primals, tangent, n=n)

    def _vjp(p, ct):
        _, pull = jax.vjp(fn, p)
        return pull(ct)

    ct = jax.tree_util.tree_map(jnp.ones_like, out)
    vjp = jax.jit(_vjp)
    res["vjp"] = median_seconds(vjp, primals, ct, n=n)
    if verbose:
        logger.info(
            "exec_time: compile %.3fs | forward %.3es | jvp %.3es | vjp %.3es"
            % (res["compile"], res["forward"], res["jvp"], res["vjp"])
        )
    return res


def cost_analysis(fn: Callable, primals) -> Mapping[str, float]:
    """XLA's cost model for the compiled `fn`: FLOPs, bytes accessed,
    transcendentals — the roofline inputs for the target hardware."""
    lowered = jax.jit(fn).lower(primals)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    keys = ("flops", "bytes accessed", "transcendentals")
    return {k: float(ca.get(k, 0.0)) for k in keys} | {
        "raw": dict(ca) if hasattr(ca, "items") else ca
    }


class CountingCall:
    """Wrap a callable and count invocations of its forward/JVP/VJP —
    the trace-time analogue of the reference's ``CountingOperator``:
    under ``jit`` each Python-level call corresponds to one inlined
    application in the compiled program, so the counts report how often a
    (sub)model appears per CG step / KL evaluation.
    """

    def __init__(self, fn: Callable, name: str = "op"):
        self.fn = fn
        self.name = name
        self.n_apply = 0
        self.n_jvp = 0
        self.n_vjp = 0

    def __call__(self, x, *args, **kwargs):
        # classify by trace type: JVPTracer → forward-mode pass
        leaves = jax.tree_util.tree_leaves(x)
        from jax._src.interpreters.ad import JVPTracer

        if any(isinstance(l, JVPTracer) for l in leaves):
            self.n_jvp += 1
        else:
            self.n_apply += 1
        return self.fn(x, *args, **kwargs)

    def reset(self):
        self.n_apply = self.n_jvp = self.n_vjp = 0

    def report(self) -> str:
        return (
            f"CountingCall({self.name}): apply={self.n_apply} "
            f"jvp={self.n_jvp}"
        )

    def __repr__(self):
        return self.report()
