"""mode_expand: exact equality with the plain gather, adjointness,
vmap/jvp/transpose behavior (the metric hot-path contract)."""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

from nifty_tpu.models.correlated_field import get_fourier_mode_distributor
from nifty_tpu.ops.mode_expand import build_expand_layout, mode_expand


def _core_and_layout(shape, distances):
    dist, um, _ = get_fourier_mode_distributor(shape, distances)
    core = dist[tuple(slice(0, n // 2 + 1) for n in shape)].astype(np.int32)
    packed, layout = build_expand_layout(core, um.size)
    return core, um.size, packed, layout


@pytest.mark.parametrize(
    "shape,distances,kind",
    [
        ((32, 32), 1.0 / 32, "rfp2"),  # square isotropic, H=17 odd
        ((30, 30), 1.0 / 30, "flat"),  # H=16 even -> fallback
        ((32, 16), (1.0 / 32, 1.0 / 16), "flat"),  # non-square
        ((64,), 1.0 / 64, "flat"),  # 1-D
    ],
)
def test_expand_matches_plain_gather(shape, distances, kind):
    core, U, packed, layout = _core_and_layout(shape, distances)
    assert layout.kind == kind
    tab = jnp.asarray(np.random.default_rng(0).standard_normal(U))
    out = mode_expand(tab, packed, layout)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(tab)[core])


def test_expand_adjointness():
    core, U, packed, layout = _core_and_layout((32, 32), 1.0 / 32)
    assert layout.kind == "rfp2"
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.standard_normal(U))
    u = jnp.asarray(rng.standard_normal(core.shape))

    f = lambda t: mode_expand(t, packed, layout)
    fT = jax.linear_transpose(f, v)
    lhs = jnp.vdot(f(v), u)
    (rhs_v,) = fT(u)
    rhs = jnp.vdot(v, rhs_v)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    # transpose equals the brute-force segment sum
    brute = jnp.zeros((U,), u.dtype).at[jnp.asarray(core)].add(u)
    np.testing.assert_allclose(np.asarray(rhs_v), np.asarray(brute), rtol=1e-12)


def test_expand_jvp_and_linearize():
    core, U, packed, layout = _core_and_layout((32, 32), 1.0 / 32)
    rng = np.random.default_rng(2)
    t0 = jnp.asarray(rng.standard_normal(U))
    dt = jnp.asarray(rng.standard_normal(U))

    def f(t):
        return mode_expand(jnp.exp(t), packed, layout)

    y, fwd = jax.linearize(f, t0)
    np.testing.assert_allclose(
        np.asarray(fwd(dt)),
        (np.exp(np.asarray(t0)) * np.asarray(dt))[core],
        rtol=1e-12,
    )
    bwd = jax.linear_transpose(fwd, t0)
    u = jnp.asarray(rng.standard_normal(core.shape))
    (cot,) = bwd(u)
    lhs = float(jnp.vdot(fwd(dt), u))
    rhs = float(jnp.vdot(dt, cot))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_expand_vmap():
    core, U, packed, layout = _core_and_layout((32, 32), 1.0 / 32)
    rng = np.random.default_rng(3)
    tb = jnp.asarray(rng.standard_normal((5, U)))
    out = jax.vmap(lambda t: mode_expand(t, packed, layout))(tb)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(tb)[:, np.asarray(core)]
    )
    # vmap of grad (sampled-VI pattern)
    def loss(t, u):
        return jnp.vdot(mode_expand(t, packed, layout), u)

    us = jnp.asarray(rng.standard_normal((5,) + core.shape))
    g = jax.vmap(jax.grad(loss))(tb, us)
    for i in range(5):
        brute = np.zeros(U)
        np.add.at(brute, core, np.asarray(us[i]))
        np.testing.assert_allclose(np.asarray(g[i]), brute, rtol=1e-12)


def test_expand_vmap_batched_index_table():
    # the model pytree (tables are dynamic leaves) may itself be vmapped:
    # the index table then arrives batched and must broadcast correctly
    core, U, packed, layout = _core_and_layout((32, 32), 1.0 / 32)
    rng = np.random.default_rng(5)
    tb = jnp.asarray(rng.standard_normal((3, U)))
    idxb = jnp.broadcast_to(packed, (3,) + packed.shape)
    out = jax.vmap(lambda t, i: mode_expand(t, i, layout))(tb, idxb)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(tb)[:, np.asarray(core)]
    )


def test_expand_under_jit():
    core, U, packed, layout = _core_and_layout((32, 32), 1.0 / 32)
    tab = jnp.asarray(np.random.default_rng(4).standard_normal(U))
    out = jax.jit(lambda t: mode_expand(t, packed, layout))(tab)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(tab)[core])


_LAYOUTS = [
    ((32, 32), 1.0 / 32, "rfp2"),
    ((48, 48), 1.0 / 48, "rfp2"),  # H=25
    ((30, 30), 1.0 / 30, "flat"),
    ((32, 16), (1.0 / 32, 1.0 / 16), "flat"),
    ((64,), 1.0 / 64, "flat"),
]


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("shape,distances,kind", _LAYOUTS)
def test_expand_and_transpose_match_numpy(shape, distances, kind, batch):
    """Forward equals ``np.take`` on the core table; the transpose equals
    ``np.add.at`` (unbatched, and with the batch as trailing columns)."""
    core, U, packed, layout = _core_and_layout(shape, distances)
    assert layout.kind == kind
    rng = np.random.default_rng(len(shape) + (batch or 0))
    tshape = (U,) if batch is None else (U, batch)
    tab = rng.standard_normal(tshape)
    f = lambda t: mode_expand(t, packed, layout)  # noqa: E731
    out = np.asarray(f(jnp.asarray(tab)))
    np.testing.assert_array_equal(out, np.take(tab, core, axis=0))
    cot = rng.standard_normal(out.shape)
    (got,) = jax.linear_transpose(f, jnp.asarray(tab))(jnp.asarray(cot))
    want = np.zeros(tshape)
    np.add.at(want, core, cot)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)
