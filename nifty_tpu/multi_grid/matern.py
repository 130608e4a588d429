"""Matérn-family isotropic covariance functions from power spectra.

The multi-grid GP needs the covariance as a function of *distance*; the
Matérn family is naturally parametrized in the spectral domain,

    P(k) ∝ (1 + (k/cutoff)²)^(loglogslope/2) ,

so the radial covariance is obtained by the d-dimensional isotropic
inverse Fourier (Hankel-type) transform

    C(r) ∝ ∫ dk k^{d-1} P(k) Λ_d(kr),   Λ_1 = cos, Λ_2 = J₀, Λ_3 = sinc,

evaluated by log-k quadrature and tabulated on a log-r grid for cheap
differentiable interpolation (reference:
``nifty/re/multi_grid/matern.py:410`` ``IsotropicPowerSpectrumTransform``
and ``:554`` ``MaternCovarianceKernel``; independent implementation —
here the Bessel weights are precomputed static tables so the learned-
parameter path is pure elementwise math plus one matmul-sized
contraction).

``J₀`` is implemented with the classic rational/asymptotic split (valid
to ~1e-8 in double precision) since jax ships no Bessel functions.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
from jax import numpy as jnp

from ..model import LazyModel, Model, WrappedCall
from ..models.prior import LogNormalPrior, NormalPrior
from ..utils.tree import ShapeWithDtype, random_like

__all__ = ["bessel_j0", "matern_spectral_covariance", "MaternCovarianceModel"]


def bessel_j0(x):
    """J₀(x), Abramowitz & Stegun 9.4.1/9.4.3 rational approximations."""
    x = jnp.asarray(x)
    ax = jnp.abs(x)

    # |x| < 8: rational approximation
    y = x * x
    p1 = 57568490574.0 + y * (
        -13362590354.0
        + y
        * (
            651619640.7
            + y * (-11214424.18 + y * (77392.33017 + y * (-184.9052456)))
        )
    )
    q1 = 57568490411.0 + y * (
        1029532985.0
        + y * (9494680.718 + y * (59272.64853 + y * (267.8532712 + y)))
    )
    small = p1 / q1

    # |x| >= 8: asymptotic form
    z = 8.0 / jnp.maximum(ax, 1e-30)
    y2 = z * z
    xx = ax - 0.785398164
    p2 = 1.0 + y2 * (
        -0.1098628627e-2
        + y2 * (0.2734510407e-4 + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6))
    )
    q2 = -0.1562499995e-1 + y2 * (
        0.1430488765e-3
        + y2 * (-0.6911147651e-5 + y2 * (0.7621095161e-6 + y2 * (-0.934935152e-7)))
    )
    large = jnp.sqrt(0.636619772 / jnp.maximum(ax, 1e-30)) * (
        jnp.cos(xx) * p2 - z * jnp.sin(xx) * q2
    )
    return jnp.where(ax < 8.0, small, large)


def _radial_weight(d: int, kr):
    if d == 1:
        return jnp.cos(kr)
    if d == 2:
        return bessel_j0(kr)
    if d == 3:
        return jnp.sinc(kr / jnp.pi)  # sin(kr)/(kr)
    raise ValueError(f"unsupported dimension {d}")


def matern_spectral_covariance(
    *,
    ndim: int,
    r_min: float,
    r_max: float,
    n_integrate: int = 2000,
    n_interpolate: int = 512,
    kr_cut: float = 1e4,
) -> Callable:
    """Build ``cov_factory(scale, cutoff, loglogslope) -> cov(r)``.

    The quadrature grid and the radial weights ``Λ_d(k·r)`` are
    precomputed as static tables over a fixed dimensionless grid
    ``q = k/cutoff``; only the spectrum values depend on the learned
    parameters, so the learned path is one weighted contraction plus an
    interpolation — cheap and exactly differentiable.
    """
    ndim = int(ndim)
    rs = np.geomspace(max(r_min, 1e-12), r_max * 1.5, n_interpolate)

    def cov_factory(scale, cutoff, loglogslope):
        scale = jnp.asarray(scale)
        cutoff = jnp.asarray(cutoff)
        loglogslope = jnp.asarray(loglogslope)

        # dimensionless log-q quadrature (q = k/cutoff): static nodes
        q = jnp.asarray(np.geomspace(1e-4, kr_cut, n_integrate))
        dlq = jnp.log(q[1] / q[0])
        spec = (1.0 + q**2) ** (loglogslope / 2.0)
        wt = q**ndim * spec * dlq  # k^{d-1} dk = q^d dlogq · cutoff^d (cancels)

        kr = q[None, :] * (cutoff * jnp.asarray(rs))[:, None]
        lam = _radial_weight(ndim, kr)
        integ = lam @ wt  # (n_interpolate,)
        i0 = jnp.sum(wt)  # Λ_d(0) = 1
        cov_tab = scale**2 * integ / i0

        log_rs = jnp.asarray(np.log(rs))

        def cov(r):
            r = jnp.asarray(r)
            lr = jnp.log(jnp.maximum(r, rs[0]))
            c = jnp.interp(lr, log_rs, cov_tab)
            return jnp.where(r <= rs[0], scale**2, c)

        return cov

    return cov_factory


class MaternCovarianceModel(LazyModel):
    """Learnable Matérn covariance: lognormal priors on scale & cutoff, a
    normal prior on the spectral slope.  Calling the model on the latent
    parameters returns the distance-covariance callable consumed by
    :class:`~nifty_tpu.multi_grid.kernel.ICRKernel`.

    Reference: ``nifty/re/multi_grid/matern.py:801``
    ``MaternCovarianceModel``; independent implementation.
    """

    scale: Union[Model, tuple] = dataclasses.field(metadata=dict(static=False))
    cutoff: Union[Model, tuple] = dataclasses.field(metadata=dict(static=False))
    loglogslope: Union[Model, tuple] = dataclasses.field(
        metadata=dict(static=False)
    )

    def __init__(
        self,
        *,
        ndim: int,
        r_min: float,
        r_max: float,
        scale=(1.0, 0.5),
        cutoff=(1.0, 0.5),
        loglogslope=(-4.0, 0.5),
        n_integrate: int = 2000,
        n_interpolate: int = 512,
        prefix: str = "matern",
    ):
        def parse(v, name, prior):
            if isinstance(v, Model):
                return v
            if isinstance(v, (tuple, list)):
                return prior(*v, name=prefix + name)
            return v  # fixed float

        self.scale = parse(scale, "scale", LogNormalPrior)
        self.cutoff = parse(cutoff, "cutoff", LogNormalPrior)
        self.loglogslope = parse(loglogslope, "loglogslope", NormalPrior)
        self._factory = matern_spectral_covariance(
            ndim=ndim,
            r_min=r_min,
            r_max=r_max,
            n_integrate=n_integrate,
            n_interpolate=n_interpolate,
        )
        domain = {}
        init = None
        for p in (self.scale, self.cutoff, self.loglogslope):
            if isinstance(p, Model):
                domain.update(p.domain)
                init = p.init if init is None else init | p.init
        super().__init__(domain=domain, init=init)

    def __call__(self, x):
        def ev(p):
            return p(x) if isinstance(p, Model) else jnp.asarray(p)

        return self._factory(ev(self.scale), ev(self.cutoff), ev(self.loglogslope))


class IsotropicPowerSpectrumTransform:
    """General isotropic power-spectrum → radial-covariance transform:

        Cov(r) = (2π)^{-d} S_{d-1} ∫₀^∞ P(k) k^{d-1} Λ_d(k·r) dk

    with the radial kernels Λ₁ = cos, Λ₂ = J₀, Λ₃ = sinc and surface
    areas S₀..₂ = 2, 2π, 4π.  Behavioral counterpart of the reference's
    Ogata-quadrature transform (``nifty/re/multi_grid/matern.py:410``);
    this implementation integrates on a static log-k grid, so the
    application is a single weighted contraction — pure JAX and exactly
    differentiable through any spectrum parametrization.  Dimensions
    1–3 are supported (the elementary-kernel cases relevant to field
    inference).

    Call with a spectrum callable and radii: ``transform(P, r) -> Cov``.
    For spectra without a high-k cutoff the integral may diverge — use
    decaying or compactly supported spectra (same advice as the
    reference).
    """

    def __init__(
        self,
        ndim: int,
        n_nodes: int = 4096,
        k_min: float = 1e-4,
        k_max: float = 1e4,
    ):
        if ndim not in (1, 2, 3):
            raise ValueError("ndim must be 1, 2, or 3")
        self.ndim = int(ndim)
        k = np.geomspace(k_min, k_max, int(n_nodes))
        dlk = float(np.log(k[1] / k[0]))
        surface = {1: 2.0, 2: 2.0 * np.pi, 3: 4.0 * np.pi}[self.ndim]
        pref = surface / (2.0 * np.pi) ** self.ndim
        # k^{d-1} dk = k^d dlog k, plus one head node covering [0, k_min)
        # analytically (∫₀^{k_min} k^{d-1} dk = k_min^d / d) — without it a
        # flat spectrum leaks a constant offset of order k_min^d
        k = np.concatenate(([0.5 * k_min], k))
        w = np.concatenate(([k_min**self.ndim / self.ndim], k[1:] ** self.ndim * dlk))
        self._k = jnp.asarray(k)
        self._w = jnp.asarray(pref * w)

    def __call__(self, power_spectrum: Callable, r):
        r = jnp.asarray(r)
        pk = power_spectrum(self._k)
        kr = self._k * r[..., None]
        lam = _radial_weight(self.ndim, kr)
        return jnp.sum(lam * (pk * self._w), axis=-1)
