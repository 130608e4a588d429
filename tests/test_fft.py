"""Hartley transform (``ops/fft.py``) against numpy's float64 FFT."""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

from nifty_tpu.ops.fft import hartley


def _numpy_hartley(x, axes=None):
    ft = np.fft.fftn(np.asarray(x, np.complex128), axes=axes)
    return ft.real - ft.imag


@pytest.mark.parametrize(
    "shape,axes",
    [
        ((64,), None),  # 1-D even
        ((63,), None),  # 1-D odd
        ((32, 32), None),  # 2-D square even
        ((31, 33), None),  # 2-D odd
        ((16, 40), None),  # non-square
        ((8, 10, 6), None),  # 3-D even
        ((7, 9, 5), None),  # 3-D odd
        ((12, 18), (0,)),  # leading axis only
        ((12, 17), (1,)),  # trailing odd axis only
        ((6, 8, 10), (0, 2)),  # non-contiguous subset
        ((6, 8, 10), (-1, -2)),  # negative axes
    ],
)
def test_hartley_real_matches_numpy(shape, axes):
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    got = np.asarray(hartley(jnp.asarray(x), axes=axes))
    want = _numpy_hartley(x, axes)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(16, 24), (9, 7)])
def test_hartley_complex_input_matches_numpy(shape):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = np.asarray(hartley(jnp.asarray(x)))
    want = _numpy_hartley(x)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(40, 36), (33, 40)])
def test_hartley_self_inverse_adjoint_and_gradient(shape):
    rng = np.random.default_rng(3)
    a, b = (jnp.asarray(rng.standard_normal(shape)) for _ in range(2))
    np.testing.assert_allclose(
        np.asarray(hartley(hartley(a))), np.asarray(a) * a.size, rtol=1e-10
    )
    lhs = float(jnp.vdot(hartley(a), b))
    rhs = float(jnp.vdot(a, hartley(b)))
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)
    # the transpose (used by the metric) is the transform itself
    g = jax.grad(lambda z: jnp.vdot(hartley(z), b))(a)
    np.testing.assert_allclose(np.asarray(g), np.asarray(hartley(b)), rtol=1e-10)


def test_hartley_float32_stays_float32():
    x = np.random.default_rng(1).standard_normal((32, 48)).astype(np.float32)
    with jax.enable_x64(False):
        got = hartley(jnp.asarray(x))
        assert got.dtype == jnp.float32
    want = _numpy_hartley(x)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6 * np.abs(want).max())
