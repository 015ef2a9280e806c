"""The lax.scan flux march (rt.discretized) on an adversarial column.

Transparent (0, 1e-9), series-branch (1e-4), ordinary and opaque (1e4)
layers, with and without the stellar beam: float32 against float64, the
thermal-only march against ``outgoing_flux``, vmapped marches against
per-column calls, and the march's derivative against finite differences.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from clearsky_tpu.rt import discretized as disc


def _column(L=19, N=1536, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    tau = rng.exponential(0.5, (L, N))
    tau[0] = 0.0
    tau[1] = 1e-9
    tau[2] = 1e-4
    tau[-1, : N // 3] = 1e4
    B = 0.5 + rng.random((L + 1, N))
    S = rng.random(N)
    a = rng.random(N) * 0.5
    return (jnp.asarray(tau, dtype), jnp.asarray(B, dtype),
            jnp.asarray(S, dtype), jnp.asarray(a, dtype))


@pytest.mark.parametrize("nstream", [1, 4, 5, 8])
def test_scan_f32_matches_f64(nstream):
    cols = {dt: _column(dtype=dt) for dt in (np.float32, np.float64)}
    up, dn = {}, {}
    for dt, (tau, B, S, a) in cols.items():
        up[dt], dn[dt] = disc.monoflux(tau, B, None, S, a, 0.841, nstream)
    for M in (up, dn):
        ref = np.asarray(M[np.float64])
        err = np.abs(np.asarray(M[np.float32], np.float64) - ref).max()
        assert err < 3e-6 * np.abs(ref).max(), err


def test_scan_olr_f32_matches_f64():
    o = {dt: disc.outgoing_flux(*_column(N=1500, dtype=dt)[:2], 5)
         for dt in (np.float32, np.float64)}
    ref = np.asarray(o[np.float64])
    err = np.abs(np.asarray(o[np.float32], np.float64) - ref).max()
    assert err < 3e-6 * ref.max(), err


def test_scan_thermal_only_matches_outgoing():
    tau, B, S, a = _column(L=7, N=512, seed=1)
    up, dn = disc.monoflux(tau, B, None, 0 * S, 0 * a, 0.841, 5)
    olr = disc.outgoing_flux(tau, B, 5)
    np.testing.assert_allclose(np.asarray(up[0]), np.asarray(olr),
                               rtol=1e-12, atol=1e-14)
    # no beam: nothing enters at the top, the atmosphere emits downward
    assert np.all(np.asarray(dn[0]) == 0.0) and np.all(np.asarray(dn[-1]) > 0.0)


def test_scan_transparent_column_emits_the_surface():
    tau, B, S, a = _column(L=5, N=256, seed=2)
    olr = disc.outgoing_flux(jnp.zeros_like(tau), B, 5)
    # exact up to the stream weights' own sum (pi to ~1e-7)
    np.testing.assert_allclose(np.asarray(olr), np.pi * np.asarray(B[-1]),
                               rtol=2e-7)


def test_vmapped_flux_paths_match_per_column():
    # batch on axis 0 and on a middle axis (the layout a vmapped quadrature
    # matmul produces)
    tau, B, S, a = _column(L=5, N=256)
    taub = jnp.stack([tau, tau * 1.3])
    Bb = jnp.stack([B, B * 1.1])
    mono = lambda t, b: disc.monoflux(t, b, None, S, a, 0.841, 5)
    up0, dn0 = jax.vmap(mono)(taub, Bb)
    up1, dn1 = jax.vmap(mono, in_axes=(1, 1))(
        jnp.moveaxis(taub, 0, 1), jnp.moveaxis(Bb, 0, 1))
    olr = jax.vmap(lambda t, b: disc.outgoing_flux(t, b, 5))(taub, Bb)
    for i in range(2):
        upr, dnr = mono(taub[i], Bb[i])
        np.testing.assert_allclose(np.asarray(up0[i]), np.asarray(upr), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(up1[i]), np.asarray(upr), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(dn0[i]), np.asarray(dnr), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(dn1[i]), np.asarray(dnr), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(olr[i]), np.asarray(disc.outgoing_flux(taub[i], Bb[i], 5)),
            rtol=1e-12)


def test_scan_derivative_matches_finite_differences():
    # every branch of the series/exp split must differentiate correctly
    tau, B, S, a = _column(L=6, N=64, seed=3)
    tau = tau.at[-1].set(jnp.minimum(tau[-1], 3.0))  # finite derivative
    f = lambda t: disc.outgoing_flux(t, B, 5).sum()
    v = jnp.asarray(np.random.default_rng(4).normal(size=tau.shape))
    v = v * jnp.maximum(tau, 1e-6) * 1e-3  # relative perturbation per layer
    _, jv = jax.jvp(f, (tau,), (v,))
    h = 1e-3
    fd = (f(tau + h * v) - f(tau - h * v)) / (2 * h)
    np.testing.assert_allclose(float(jv), float(fd), rtol=1e-6)
