"""Radiation primitives: spectral unit conversions, Planck law, Schwarzschild RHS.

Array-first equivalents of the reference's radiation layer (ClearSky.jl
``src/radiation.jl``). All functions are elementwise jnp, jit/vmap-safe, and
broadcast over arrays of wavenumbers/temperatures.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import (
    C_LIGHT,
    H_PLANCK,
    K_BOLTZ,
    SIGMA_SB,
    N_AVOGADRO,
    C2_RADIATION,
)

__all__ = [
    "nu2f",
    "f2nu",
    "nu2lam",
    "lam2nu",
    "lam2f",
    "f2lam",
    "planck",
    "normplanck",
    "dplanck",
    "stefanboltzmann",
    "equilibrium_temperature",
    "equilibrium_temperature_luminosity",
    "dtau_dP",
    "transmittance",
    "schwarzschild_dIdz",
    "schwarzschild_dIdP",
    "absorption_dIdP",
    "emission_dIdP",
]


# spectral unit conversions (ref radiation.jl:4-34)
def nu2f(nu):
    """Wavenumber [cm^-1] to frequency [1/s]. Ref radiation.jl:9."""
    return 100.0 * C_LIGHT * nu


def f2nu(f):
    """Frequency [1/s] to wavenumber [cm^-1]. Ref radiation.jl:14."""
    return f / (100.0 * C_LIGHT)


def nu2lam(nu):
    """Wavenumber [cm^-1] to wavelength [m]. Ref radiation.jl:19."""
    return 0.01 / nu


def lam2nu(lam):
    """Wavelength [m] to wavenumber [cm^-1]. Ref radiation.jl:24."""
    return 0.01 / lam


def lam2f(lam):
    """Wavelength [m] to frequency [1/s]. Ref radiation.jl:29."""
    return C_LIGHT / lam


def f2lam(f):
    """Frequency [1/s] to wavelength [m].

    Note: the reference's ``f2λ(f) = f/𝐜`` (ref radiation.jl:34) is not the
    inverse of its ``λ2f = 𝐜/λ`` — an upstream bug we deliberately do not
    replicate; the correct inverse is c/f.
    """
    return C_LIGHT / f


def planck(nu, T):
    """Blackbody intensity [W/m^2/cm^-1/sr] at wavenumber nu [cm^-1], temp T [K].

    Ref radiation.jl:48-54. Computed in the underflow-safe form
    ``p * e^{-x} / (1 - e^{-x})`` rather than ``p / (e^x - 1)``: the naive form
    overflows e^x to inf for large x, which is fine for the value (-> 0) but
    poisons jax derivatives with inf/inf = NaN (the Jacobian of the RCM
    heating flows through here via ``jax.jacfwd``).

    The exponent is formed as ``C2 * nu / T`` with the radiation constant
    pre-folded (hc/k as one python scalar): spelling it ``h c nu/(k T)``
    builds the float32 intermediate ``(kT) ~ 2e-21`` whose square in the
    division JVP underflows to 0 and NaNs every tangent in float32 (f32-only —
    invisible to the f64 CPU suite).
    """
    nu_m = 100.0 * nu
    x = C2_RADIATION * nu / T  # = h c nu_m / (k T), folded constant
    p = 2.0 * H_PLANCK * C_LIGHT**2 * nu_m**3
    em = jnp.exp(-x)
    return 100.0 * p * em / (-jnp.expm1(-x))


def normplanck(nu, T):
    """planck normalized by sigma*T^4 [1/cm^-1/sr]. Ref radiation.jl:71."""
    return planck(nu, T) / stefanboltzmann(T)


def dplanck(nu, T):
    """dB/dT [W/m^2/cm^-1/sr/K], with overflow guard. Ref radiation.jl:78-88.

    Formed as ``planck-prefactor * (x/T) * e^{-x}/(1-e^{-x})^2``: the naive
    prefactor ``2 h^2 c^3`` is 2.35e-41 — zero in float32 — so the f32 path
    must never materialize it (see the same hazard note in :func:`planck`).
    """
    nu_m = 100.0 * nu
    x = C2_RADIATION * nu / T
    # guard: for huge x, exp overflows; y/(y-1)^2 -> 0. Compute in a stable form:
    # y/(y-1)^2 = exp(-x) / (1 - exp(-x))^2
    em = jnp.exp(-x)
    frac = em / jnp.square(-jnp.expm1(-x))
    p = (2.0 * H_PLANCK * C_LIGHT**2 * nu_m**3) * (x / T)
    return 100.0 * p * frac


def stefanboltzmann(T):
    """sigma * T^4 [W/m^2]. Ref radiation.jl:95."""
    return SIGMA_SB * T**4


def equilibrium_temperature(F, A):
    """Planetary equilibrium temperature from flux and albedo. Ref radiation.jl:108."""
    return ((1.0 - A) * F / (4.0 * SIGMA_SB)) ** 0.25


def equilibrium_temperature_luminosity(L, A, R):
    """Equilibrium temperature from luminosity, albedo, distance. Ref radiation.jl:122."""
    return (L * (1.0 - A) / (16.0 * SIGMA_SB * jnp.pi * R**2)) ** 0.25


def dtau_dP(sigma, g, mu):
    """dtau/dP [1/Pa] = 1e-4 * sigma * Na / (mu * g). Ref radiation.jl:141."""
    return 1e-4 * sigma * N_AVOGADRO / (mu * g)


def transmittance(tau):
    """t = exp(-tau). Ref radiation.jl:148."""
    return jnp.exp(-tau)


def schwarzschild_dIdz(I, nu, sigma, T, P):
    """dI/dz [per m] Schwarzschild RHS in height coordinates. Ref radiation.jl:166."""
    return 1e-4 * sigma * (P / (K_BOLTZ * T)) * (planck(nu, T) - I)


def schwarzschild_dIdP(I, nu, sigma, g, mu, T):
    """dI/dP Schwarzschild RHS in pressure coordinates. Ref radiation.jl:185."""
    return 1e-4 * sigma * (N_AVOGADRO / (mu * g)) * (planck(nu, T) - I)


def absorption_dIdP(I, sigma, g, mu):
    """Absorption-only RHS (no emission). Ref radiation.jl:202."""
    return -1e-4 * sigma * (N_AVOGADRO / (mu * g)) * I


def emission_dIdP(nu, sigma, g, mu, T):
    """Emission-only RHS. Ref radiation.jl:219."""
    return 1e-4 * sigma * (N_AVOGADRO / (mu * g)) * planck(nu, T)
