"""Keplerian orbital mechanics.

Array-first equivalent of ClearSky.jl ``src/orbits.jl``. The reference solves
Kepler's equation per time sample with a bracketing regula-falsi root find
(ref orbits.jl:63-72); here the solve is a fixed-iteration Newton scheme —
branch-free, jit/vmap-safe, and accurate to float64 roundoff for e < 0.97
within the fixed iteration count (validated in tests against the defining
equation M = E - e sin E).

All functions accept scalars or arrays and broadcast.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..constants import G_GRAV

__all__ = [
    "periapsis",
    "apoapsis",
    "semimajoraxis",
    "eccentricity",
    "meananomaly",
    "trueanomaly",
    "eccentricanomaly",
    "orbitalperiod",
    "orbitaldistance",
    "orbit",
]

_KEPLER_ITERS = 20


def periapsis(a, e):
    """Closest-approach distance a(1-e). Ref orbits.jl:10."""
    return a * (1.0 - e)


def apoapsis(a, e):
    """Farthest distance a(1+e). Ref orbits.jl:17."""
    return a * (1.0 + e)


def semimajoraxis(T, m):
    """Semi-major axis from period and host mass (Kepler III). Ref orbits.jl:24."""
    return (G_GRAV * m * T**2 / (4.0 * jnp.pi**2)) ** (1.0 / 3.0)


def eccentricity(rp, ra):
    """Eccentricity from periapsis/apoapsis distances. Ref orbits.jl:31."""
    return (ra - rp) / (ra + rp)


def meananomaly(E, e):
    """Mean anomaly M = E - e sin E. Ref orbits.jl:38."""
    return E - e * jnp.sin(E)


def orbitalperiod(a, m):
    """Orbital period 2 pi sqrt(a^3/(G m)) (Kepler III). Ref orbits.jl:80."""
    return 2.0 * jnp.pi * jnp.sqrt(a**3 / (G_GRAV * m))


def _kepler_newton(M, e):
    """Solve M = E - e sin E for E by fixed-count Newton iteration.

    Replaces the reference's regula falsi on [0, 2 pi] (ref orbits.jl:63-72)
    with a branch-free scheme: start from the standard initializer
    E0 = M + e sin M and iterate; quadratic convergence makes 20 iterations
    overkill for any planetary eccentricity.
    """
    M = jnp.asarray(M)
    e = jnp.asarray(e)
    E0 = M + e * jnp.sin(M)

    def body(_, E):
        f = E - e * jnp.sin(E) - M
        fp = 1.0 - e * jnp.cos(E)
        return E - f / fp

    return lax.fori_loop(0, _KEPLER_ITERS, body, E0)


def eccentricanomaly(t, a, m, e):
    """Eccentric anomaly at time t (periapsis at t=0). Ref orbits.jl:63-72."""
    T = orbitalperiod(a, m)
    M = 2.0 * jnp.pi * jnp.remainder(jnp.asarray(t), T) / T
    return _kepler_newton(M, e)


def _trueanomaly_from_E(E, e):
    """True anomaly from eccentric anomaly, mapped onto [0, 2 pi). Ref orbits.jl:45-52."""
    f = 2.0 * jnp.arctan(jnp.sqrt((1.0 + e) / (1.0 - e)) * jnp.tan(E / 2.0))
    return jnp.where(f < 0, f + 2.0 * jnp.pi, f)


def trueanomaly(*args):
    """True anomaly: ``trueanomaly(E, e)`` or ``trueanomaly(t, a, m, e)``.

    Ref orbits.jl:45-59.
    """
    if len(args) == 2:
        return _trueanomaly_from_E(*args)
    if len(args) == 4:
        t, a, m, e = args
        return _trueanomaly_from_E(eccentricanomaly(t, a, m, e), e)
    raise TypeError("trueanomaly takes (E, e) or (t, a, m, e)")


def orbitaldistance(*args):
    """Host-planet distance: ``orbitaldistance(a, f, e)`` from true anomaly, or
    ``orbitaldistance(t, a, m, e)`` from time (periapsis at t=0). Ref orbits.jl:87-99."""
    if len(args) == 3:
        a, f, e = args
        return a * (1.0 - e**2) / (1.0 + e * jnp.cos(f))
    if len(args) == 4:
        t, a, m, e = args
        f = trueanomaly(t, a, m, e)
        return orbitaldistance(a, f, e)
    raise TypeError("orbitaldistance takes (a, f, e) or (t, a, m, e)")


def orbit(a, m, e, N: int = 1000):
    """Time series of one orbit: (t, r, f) with N samples. Ref orbits.jl:100-106."""
    T = orbitalperiod(a, m)
    t = jnp.linspace(0.0, T, N + 1)[:-1]
    f = trueanomaly(t, a, m, e)
    r = orbitaldistance(a, f, e)
    return t, r, f
