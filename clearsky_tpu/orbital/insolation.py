"""Insolation: diurnally and annually averaged stellar flux factors.

Array-first equivalent of ClearSky.jl ``src/insolation.jl``. The reference's
annual average uses the adaptive C `cubature` library (ref insolation.jl:89-94,
the only native code in its dependency tree); here it is a fixed-order
composite Gauss-Legendre quadrature over the orbital period — dense, static,
batched over latitudes in one shot. All functions broadcast over array inputs.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .orbits import orbitalperiod, trueanomaly, orbitaldistance

__all__ = [
    "substellarlatitude",
    "hourangle",
    "diurnalfluxfactor",
    "diurnalfluxfactors",
    "annualfluxfactor",
    "annualfluxfactors",
]


def substellarlatitude(f, gamma):
    """Latitude of the substellar point at solar longitude f, obliquity gamma.

    Ref insolation.jl:10.
    """
    return jnp.arcsin(jnp.cos(f) * jnp.sin(gamma))


def hourangle(theta, theta_s):
    """Sunrise/sunset hour angle with polar day/night clamps. Ref insolation.jl:17-25.

    The cosine product in the denominator is floored at a tiny positive value:
    mathematically cos >= 0 on [-pi/2, pi/2], but float32's nearest pi/2
    rounds past the true value and cos comes out NEGATIVE (~-4.4e-8), which
    flips the polar day/night clamp and silently negates polar insolation in
    float32.
    """
    denom = jnp.maximum(jnp.cos(theta) * jnp.cos(theta_s), 1e-30)
    x = -jnp.sin(theta) * jnp.sin(theta_s) / denom
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def _diurnal_factor(theta, theta_s):
    """Diurnal average of the cosine of the stellar zenith angle. Ref insolation.jl:34-37."""
    h = hourangle(theta, theta_s)
    return (
        jnp.sin(h) * jnp.cos(theta) * jnp.cos(theta_s)
        + h * jnp.sin(theta) * jnp.sin(theta_s)
    ) / jnp.pi


def diurnalfluxfactor(*args):
    """Diurnally averaged fraction of incoming stellar flux.

    Call forms (ref insolation.jl:34-58):
      * ``diurnalfluxfactor(theta, theta_s)`` — latitude & substellar latitude;
      * ``diurnalfluxfactor(theta, f, gamma)`` — solar longitude & obliquity;
      * ``diurnalfluxfactor(t, a, m, e, theta, gamma, p)`` — full elliptical
        orbit with precession angle p and the (a/r)^2 distance factor.
    """
    if len(args) == 2:
        return _diurnal_factor(*args)
    if len(args) == 3:
        theta, f, gamma = args
        return _diurnal_factor(theta, substellarlatitude(f, gamma))
    if len(args) == 7:
        t, a, m, e, theta, gamma, p = args
        f = trueanomaly(t, a, m, e)
        r = orbitaldistance(a, f, e)
        return diurnalfluxfactor(theta, f - p, gamma) * (a / r) ** 2
    raise TypeError(
        "diurnalfluxfactor takes (theta, theta_s), (theta, f, gamma), or "
        "(t, a, m, e, theta, gamma, p)"
    )


def diurnalfluxfactors(*args, nf: int = 251, nt: int = 251, ntheta: int = 181):
    """Grids of diurnally averaged flux factors.

    ``diurnalfluxfactors(gamma)`` — circular orbit: returns (f, theta, F) with
    F[ntheta, nf] (ref insolation.jl:65-70). ``diurnalfluxfactors(a, m, e,
    gamma, p)`` — elliptical orbit over one period: returns (t, theta, F) with
    F[ntheta, nt] (ref insolation.jl:77-82).
    """
    theta = jnp.linspace(-jnp.pi / 2, jnp.pi / 2, ntheta)
    if len(args) == 1:
        (gamma,) = args
        f = jnp.linspace(0.0, 2.0 * jnp.pi, nf)
        F = diurnalfluxfactor(theta[:, None], f[None, :], gamma)
        return f, theta, F
    if len(args) == 5:
        a, m, e, gamma, p = args
        t = jnp.linspace(0.0, orbitalperiod(a, m), nt)
        F = diurnalfluxfactor(t[None, :], a, m, e, theta[:, None], gamma, p)
        return t, theta, F
    raise TypeError("diurnalfluxfactors takes (gamma) or (a, m, e, gamma, p)")


def _annual_quad_nodes(npanel: int, order: int):
    """Composite Gauss-Legendre nodes/weights on [0, 1] (host-side, static)."""
    x, w = np.polynomial.legendre.leggauss(order)
    edges = np.linspace(0.0, 1.0, npanel + 1)
    mid = 0.5 * (edges[:-1] + edges[1:])
    half = 0.5 * np.diff(edges)
    nodes = (mid[:, None] + half[:, None] * x[None, :]).ravel()
    weights = (half[:, None] * w[None, :]).ravel()
    return jnp.asarray(nodes), jnp.asarray(weights)


def annualfluxfactor(e, theta, gamma, p, npanel: int = 32, order: int = 8):
    """Annually averaged flux factor for latitude theta on an elliptical orbit.

    Ref insolation.jl:89-94, with the adaptive C quadrature replaced by a
    fixed composite Gauss-Legendre rule over one period (a=m=1 convention,
    matching the reference). Broadcasts over array ``theta``.
    """
    T = orbitalperiod(1.0, 1.0)
    x, w = _annual_quad_nodes(npanel, order)
    t = x * T
    theta = jnp.asarray(theta)
    F = diurnalfluxfactor(t, 1.0, 1.0, e, theta[..., None], gamma, p)
    return jnp.sum(F * w, axis=-1)


def annualfluxfactors(e, gamma, p, ntheta: int = 181):
    """Annually averaged flux factors across latitudes. Ref insolation.jl:99-103.

    Returns (theta, F) with F[ntheta].
    """
    theta = jnp.linspace(-jnp.pi / 2, jnp.pi / 2, ntheta)
    return theta, annualfluxfactor(e, theta, gamma, p)
