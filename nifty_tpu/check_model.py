"""Model jit-hygiene checker: timings, memory, and inlined-constant linting.

For each of forward / JVP / VJP this benchmarks the model with and
without jit, reads XLA's ``memory_analysis()``, and parses the compiled
HLO for large inlined constants — the classic symptom of a model closing
over concrete arrays instead of tracing them (costly recompiles and device-memory
waste).  It also lists the model's pytree leaves (arrays that
correctly remain runtime inputs).

Behavioral parity with ``nifty/re/check_model.py``; independent
implementation.
"""

from __future__ import annotations

import math
import re as _re
from timeit import Timer

import jax
from jax.tree_util import Partial

from .logger import logger
from .model import LazyModel
from .utils.tree import ones_like

__all__ = ["check_model"]


def _benchmark(func, *args):
    f = lambda: jax.block_until_ready(func(*args))  # noqa: E731
    f()  # warmup / compile
    n, dt = Timer(f).autorange()
    return dt / n


def _dtype_bits(dtype: str) -> float:
    m = _re.search(r"(\d+)$", dtype)
    return float(m.group(1)) if m else float("nan")


def parse_hlo_constants(hlo_text: str):
    """Collect shapes of ``%constant`` definitions in an HLO dump, grouped
    by dtype; returns (shapes-per-dtype, element-count-per-dtype,
    bytes-per-dtype)."""
    pattern = r"^\s*%?constant[\.\d]*\s*=\s*([a-zA-Z0-9]+)\[([0-9,\s]*)\]"
    shapes_by_dtype = {}
    for dtype, shape_str in _re.findall(pattern, hlo_text, _re.MULTILINE):
        shape = (
            [] if not shape_str.strip() else [int(s) for s in shape_str.split(",")]
        )
        shapes_by_dtype.setdefault(dtype, []).append(shape)
    totals, mem = {}, {}
    for dtype, shapes in shapes_by_dtype.items():
        shapes.sort(key=lambda s: math.prod(s) if s else 0, reverse=True)
        totals[dtype] = sum(math.prod(s) if s else 1 for s in shapes)
        mem[dtype] = totals[dtype] * _dtype_bits(dtype) / 8.0
    return shapes_by_dtype, totals, mem


def check_model(model, pos, *, log=None):
    """Benchmark and lint a model's forward/JVP/VJP passes.

    Returns a report dict ``{mode: {"time_raw", "time_jit",
    "hlo_constants": (shapes, sizes, bytes)}}`` and logs a human-readable
    summary.
    """
    log = logger.info if log is None else log
    model = model if isinstance(model, LazyModel) else Partial(model)
    cotangent = ones_like(jax.eval_shape(model, pos))

    modes = {
        "forward": (lambda m, x: m(x), (model, pos)),
        "jvp": (lambda m, p, t: jax.jvp(m, (p,), (t,)), (model, pos, pos)),
        "vjp": (lambda m, p, t: jax.vjp(m, p)[1](t), (model, pos, cotangent)),
    }
    report = {}
    for name, (fn, args) in modes.items():
        compiled = jax.jit(fn).lower(*args).compile()
        time_raw = _benchmark(fn, *args)
        time_jit = _benchmark(compiled, *args)
        try:
            mem = compiled.memory_analysis()
        except Exception:  # backend without memory analysis
            mem = None
        consts, sizes, mem_bytes = parse_hlo_constants(compiled.as_text())
        report[name] = {
            "time_raw": time_raw,
            "time_jit": time_jit,
            "memory_analysis": mem,
            "hlo_constants": (consts, sizes, mem_bytes),
        }
        msg = (
            f"=== {name} ===\n"
            f"  * time (no jit): {time_raw:.1e}s\n"
            f"  * time (jit):    {time_jit:.1e}s\n"
        )
        if mem is not None:
            msg += f"  * memory: {mem}\n"
        for dtype in consts:
            msg += (
                f"  * inlined {dtype} constants: "
                f"largest {consts[dtype][:5]}, "
                f"total {sizes[dtype]} elems / {mem_bytes[dtype]:.1e} B\n"
            )
        log(msg)

    leaves = jax.tree_util.tree_leaves(model)
    msg = "model leaves (runtime inputs, not inlined):\n"
    for leaf in leaves:
        if isinstance(leaf, jax.Array):
            msg += f"  * shape {leaf.shape} dtype {leaf.dtype}\n"
        else:
            msg += f"  * non-array leaf of type {type(leaf).__name__}\n"
    log(msg)
    return report
