"""Foundation tests: constants, grids, quadrature, interpolation, radiation."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import integrate

from clearsky_tpu import constants as c
from clearsky_tpu.utils.grids import (
    chebygrid,
    pressuregrid,
    logrange,
    trapz,
    deriv,
    p2omega,
    omega2p,
)
from clearsky_tpu.utils.quadrature import gauss_legendre, gauss_lobatto, stream_nodes
from clearsky_tpu.utils.interp import (
    interp_linear,
    cheb2d_coeffs,
    cheb2d_eval,
    bilinear,
)
from clearsky_tpu.utils.rootfind import regula_falsi, secant, bisect_jax
from clearsky_tpu.ops import planck as rad


def test_chebygrid_endpoints():
    g = chebygrid(2.0, 10.0, 12)
    assert g[0] == pytest.approx(2.0)
    assert g[-1] == pytest.approx(10.0)
    assert np.all(np.diff(g) > 0)


def test_pressuregrid():
    P = pressuregrid(1.0, 1e5, 20)
    assert P[0] == pytest.approx(1.0)
    assert P[-1] == pytest.approx(1e5)


def test_trapz_matches_numpy():
    x = np.sort(np.random.RandomState(0).uniform(0, 10, 200))
    y = np.sin(x)
    assert float(trapz(x, y)) == pytest.approx(np.trapezoid(y, x))


def test_deriv():
    x = np.linspace(0, 3, 200)
    y = x**2
    d = np.asarray(deriv(x, y))
    assert np.allclose(d[1:-1], 2 * x[1:-1], atol=1e-8)


def test_omega_roundtrip():
    P = np.array([1.0, 100.0, 1e5])
    assert np.allclose(np.asarray(omega2p(p2omega(P))), P)


def test_gauss_lobatto_integrates_polynomials():
    # n-point Lobatto is exact to degree 2n-3
    for n in [2, 3, 4, 6]:
        x, w = gauss_lobatto(n)
        for d in range(2 * n - 2):
            exact = (1 - (-1) ** (d + 1)) / (d + 1)
            assert np.sum(w * x**d) == pytest.approx(exact, abs=1e-12)


def test_stream_nodes_hemispheric_closure():
    # integral of cos(theta)sin(theta) over hemisphere = pi; isotropic I=1 -> flux pi
    # 5-node GL in theta is not exact for trig weights; ~1e-7 closure error
    m, W = stream_nodes(5)
    assert np.sum(W) == pytest.approx(np.pi, rel=1e-6)
    m16, W16 = stream_nodes(16)
    assert np.sum(W16) == pytest.approx(np.pi, rel=1e-12)


def test_interp_linear_extrapolates():
    xp = np.array([0.0, 1.0, 2.0])
    fp = np.array([0.0, 2.0, 4.0])
    out = np.asarray(interp_linear(np.array([-1.0, 0.5, 3.0]), xp, fp))
    assert np.allclose(out, [-2.0, 1.0, 6.0])


def test_interp_linear_batched():
    xp = np.linspace(0, 1, 5)
    fp = np.stack([xp, xp**2])
    out = np.asarray(interp_linear(np.array([0.3]), xp, fp))
    assert out.shape == (2, 1)


def test_cheb2d_interpolation_accuracy():
    from clearsky_tpu.utils.grids import chebygrid

    f = lambda x, y: np.exp(-0.3 * x) * np.sin(y) + 0.1 * x * y
    gx = chebygrid(0.0, 3.0, 14)
    gy = chebygrid(-2.0, 2.0, 14)
    vals = f(gx[:, None], gy[None, :])
    C = cheb2d_coeffs(jnp.asarray(vals))
    xs = np.random.RandomState(0).uniform(0, 3, 50)
    ys = np.random.RandomState(1).uniform(-2, 2, 50)
    out = np.asarray(cheb2d_eval(C, xs, 0.0, 3.0, ys, -2.0, 2.0))
    assert np.allclose(out, f(xs, ys), atol=1e-9)


def test_bilinear():
    xp = np.linspace(0, 1, 11)
    yp = np.linspace(0, 2, 21)
    fp = xp[:, None] * 2 + yp[None, :]
    out = np.asarray(bilinear(np.array([0.55]), np.array([1.31]), xp, yp, fp))
    assert out[0] == pytest.approx(0.55 * 2 + 1.31)


def test_rootfinders():
    F = lambda x, p: x**2 - 2.0
    assert regula_falsi(F, 0.0, 2.0) == pytest.approx(np.sqrt(2), abs=1e-6)
    assert secant(F, 1.0, 2.0) == pytest.approx(np.sqrt(2), abs=1e-6)
    r = bisect_jax(lambda x: x**2 - 2.0, jnp.array([0.0]), jnp.array([2.0]))
    assert float(r[0]) == pytest.approx(np.sqrt(2), abs=1e-10)


def test_planck_integrates_to_stefan_boltzmann():
    # pi * int B dnu = sigma T^4
    T = 288.0
    nu = np.linspace(0.5, 20000, 40000)
    B = np.asarray(rad.planck(nu, T))
    total = np.pi * np.trapezoid(B, nu)
    assert total == pytest.approx(float(rad.stefanboltzmann(T)), rel=1e-4)


def test_dplanck_matches_analytic():
    # numpy oracle: dB/dT = 100*p0*(x/T)*e^x/(e^x-1)^2. (XLA CPU exp carries
    # ~3e-8 relative error, so jnp finite differences are noise-limited.)
    T, nu = 255.0, 600.0
    num = 100.0 * nu
    x = c.H_PLANCK * c.C_LIGHT * num / (c.K_BOLTZ * T)
    p0 = 2 * c.H_PLANCK * c.C_LIGHT**2 * num**3
    oracle = 100.0 * p0 * (x / T) * np.exp(x) / np.expm1(x) ** 2
    assert float(rad.dplanck(nu, T)) == pytest.approx(oracle, rel=1e-7)


def test_dplanck_overflow_guard():
    assert float(rad.dplanck(1e5, 1.0)) == 0.0


def test_unit_conversions_roundtrip():
    nu = 667.0
    assert float(rad.f2nu(rad.nu2f(nu))) == pytest.approx(nu)
    assert float(rad.lam2nu(rad.nu2lam(nu))) == pytest.approx(nu)
    lam = 1e-5
    assert float(rad.f2lam(rad.lam2f(lam))) == pytest.approx(lam)


def test_equilibrium_temperature():
    # Earth-ish: F=1361, A=0.3 -> ~255 K
    assert float(rad.equilibrium_temperature(1361.0, 0.3)) == pytest.approx(254.6, abs=0.5)


def test_logrange_endpoints():
    r = logrange(1.0, 10.0, 11, 2.0)
    assert r[0] == pytest.approx(1.0)
    assert r[-1] == pytest.approx(10.0)


def test_planck_jvp_float32_finite():
    """float32 Planck derivatives must be finite everywhere (f32 regression).

    The exponent must be formed as C2*nu/T with the radiation constant
    pre-folded: spelling it h*c*nu/(k*T) creates the f32 intermediate
    (kT)~2e-21 whose square underflows to 0 inside the division JVP and NaNs
    every tangent of the RCM Jacobian in float32 (found on hardware; invisible in
    this f64 suite without the explicit f32 cast below).
    """
    import jax

    nu = jnp.asarray(np.linspace(1.0, 20000.0, 512), jnp.float32)
    T = jnp.asarray(np.linspace(100.0, 400.0, 16), jnp.float32)
    out, tang = jax.jvp(
        lambda t: rad.planck(nu[None, :], t[:, None]), (T,), (jnp.ones_like(T),)
    )
    assert bool(jnp.isfinite(out).all())
    assert bool(jnp.isfinite(tang).all())
    # the tangent IS dB/dT: must agree with the closed-form dplanck
    dp = rad.dplanck(nu[None, :], T[:, None])
    assert bool(jnp.isfinite(dp).all())
    scale = float(jnp.abs(dp).max())
    assert float(jnp.abs(tang - dp).max()) / scale < 1e-5
