"""Spectral line-shape kernels: TIPS intensity scaling, Doppler/Lorentz/Voigt,
and the Perrin & Hartmann sub-Lorentzian CO2 chi factor.

Array-first equivalents of ClearSky.jl ``src/absorption/line_shapes.jl``. The
reference evaluates one (wavenumber, line) pair at a time through scalar
closures; here every function is elementwise/broadcasting jnp so whole
[wavenumber x line] tiles evaluate at once.

Units follow HITRAN conventions throughout (wavenumbers in cm^-1, cross
sections in cm^2/molecule).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import C2_RADIATION, T_REF_HITRAN, C_LIGHT, R_GAS, P_ATM, TIPS_TMIN, TIPS_TMAX
from .faddeeva import wofz_re

__all__ = [
    "cheb_qref_q",
    "scale_intensity",
    "alpha_doppler",
    "gamma_lorentz",
    "fdoppler",
    "florentz",
    "fvoigt",
    "doppler_xsec",
    "lorentz_xsec",
    "voigt_xsec",
    "chi_phco2",
    "phco2_xsec",
]

_SQRT_PI = 1.7724538509055159
_SQRT_LN2 = 0.8325546111576977          # sqrt(ln 2)   (ref line_shapes.jl:4)
_INV_SQRT_PI_LN2 = 0.46971863934982566  # 1/sqrt(pi/ln 2)  (ref line_shapes.jl:3)


def cheb_qref_q(T, coeffs, mask=None):
    """Qref/Q from the TIPS Chebyshev fit, batched over lines.

    ``coeffs``: [..., ncheb_max] zero-padded Chebyshev coefficients of
    Q(T)/Qref; returns 1/sum(a_k T_k(tau)). Ref line_shapes.jl:27-48. ``T`` is
    a scalar or array broadcastable against coeffs[..., 0]. Table-mode gases
    validate [TIPS_TMIN, TIPS_TMAX] at AtmosphericDomain construction (as in
    the reference); the direct (table-free) mode has no such gate, and a
    Chebyshev sum outside [-1, 1] diverges — it can go NEGATIVE, silently
    producing negative intensities/cross-sections. The argument is therefore
    clamped: out-of-range temperatures hold Q at the domain-edge value
    (bounded, positive, jit-safe) instead of extrapolating garbage.
    """
    coeffs = jnp.asarray(coeffs)
    n = coeffs.shape[-1]
    tau = 2.0 * (T - TIPS_TMIN) / (TIPS_TMAX - TIPS_TMIN) - 1.0
    tau = jnp.clip(jnp.asarray(tau), -1.0, 1.0)
    # Chebyshev basis via recurrence; contract with coefficients
    c1 = jnp.ones_like(tau)
    c2 = tau
    y = coeffs[..., 0] * c1
    if n > 1:
        y = y + coeffs[..., 1] * c2
    for k in range(2, n):
        c3 = 2.0 * tau * c2 - c1
        y = y + coeffs[..., k] * c3
        c1, c2 = c2, c3
    if mask is not None:
        y = jnp.where(mask, y, 1.0)
    return 1.0 / y


def scale_intensity(S, nu_l, Epp, qref_q, T):
    """HITRAN line-intensity temperature scaling. Ref line_shapes.jl:107-123.

    S(T) = S * (Qref/Q(T)) * [exp(-c2 Epp/T)(1 - exp(-c2 nu/T))]
                           / [exp(-c2 Epp/Tref)(1 - exp(-c2 nu/Tref))]

    ``qref_q`` is the TIPS partition ratio from :func:`cheb_qref_q`.
    """
    a = -C2_RADIATION * Epp
    b = -C2_RADIATION * nu_l
    n = jnp.exp(a / T) * (-jnp.expm1(b / T))
    d = jnp.exp(a / T_REF_HITRAN) * (-jnp.expm1(b / T_REF_HITRAN))
    return S * qref_q * (n / d)


def alpha_doppler(nu_l, mu, T):
    """Doppler (gaussian) HWHM-like broadening coefficient. Ref line_shapes.jl:144.

    alpha = (nu_l / c) sqrt(2 R T / mu), with mu the isotopologue molar mass
    [kg/mole].
    """
    return (nu_l / C_LIGHT) * jnp.sqrt(2.0 * R_GAS * T / mu)


def gamma_lorentz(ga, gs, na, T, P, Pp):
    """Pressure-broadened Lorentz HWHM [cm^-1]. Ref line_shapes.jl:255-257.

    gamma = (296/T)^na * (ga*(P - Pp) + gs*Pp) / atm, pressures in Pa.
    """
    return ((T_REF_HITRAN / T) ** na) * (ga * (P - Pp) + gs * Pp) / P_ATM


def fdoppler(dnu, alpha):
    """Doppler (gaussian) profile at distance dnu = nu - nu_l. Ref line_shapes.jl:160."""
    return jnp.exp(-(dnu * dnu) / (alpha * alpha)) / (alpha * _SQRT_PI)


def florentz(dnu, gamma):
    """Lorentz profile at distance dnu. Ref line_shapes.jl:273."""
    return gamma / (jnp.pi * (dnu * dnu + gamma * gamma))


def fvoigt(dnu, alpha, gamma):
    """Voigt profile via the real Faddeeva function.

    f = Re w((dnu + i gamma)/alpha) / (alpha sqrt(pi)), where alpha is the
    Gaussian 1/e half-width — the quantity ``alpha_doppler`` computes
    (ref line_shapes.jl:144). This is the standard Voigt formula for that
    width convention and converges exactly to ``fdoppler`` as gamma -> 0 and
    to ``florentz`` as gamma/alpha -> inf.

    DELIBERATE DEVIATION from the reference: ref line_shapes.jl:366-378
    additionally multiplies x, y (and the prefactor) by sqrt(ln2) — the
    HITRAN *HWHM*-convention formula — while feeding it the 1/e width from
    ``αdoppler`` and using the no-ln2 Gaussian in ``fdoppler``
    (ref line_shapes.jl:160). That convention mix inflates the effective
    Doppler width by 1/sqrt(ln2) ~ 1.20x in every Voigt evaluation; we keep
    the internally consistent form (SURVEY.md §7.2: behavioral bugs are not
    replicated).
    """
    beta = 1.0 / alpha
    x = dnu * beta
    y = gamma * beta
    return (beta / _SQRT_PI) * wofz_re(x, y)


def fvoigt_ref(dnu, alpha, gamma):
    """Reference-convention Voigt profile, reproduced EXACTLY.

    Ref line_shapes.jl:366-378: x = sqrt(ln2) dnu/alpha, y = sqrt(ln2)
    gamma/alpha, f = sqrt(ln2/pi)/alpha * Re w(x + iy) — the HWHM-convention
    formula applied to the 1/e width ``alpha_doppler`` produces (the
    convention mix documented in :func:`fvoigt`). Algebraically identical to
    ``fvoigt(dnu, alpha/sqrt(ln2), gamma)``; provided for allclose
    cross-validation against reference outputs. The line-sum kernels expose
    it as shapes ``'voigt_ref'``/``'phco2_ref'`` (see ``ops.linesum.PROFILES``).
    """
    x = _SQRT_LN2 * dnu / alpha
    y = _SQRT_LN2 * gamma / alpha
    return (_SQRT_LN2 / (alpha * _SQRT_PI)) * wofz_re(x, y)


def doppler_xsec(dnu, S, alpha):
    """Doppler cross-section contribution S * fdoppler. Ref line_shapes.jl:173."""
    return S * fdoppler(dnu, alpha)


def lorentz_xsec(dnu, S, gamma):
    """Lorentz cross-section contribution. Ref line_shapes.jl:286."""
    return S * florentz(dnu, gamma)


def voigt_xsec(dnu, S, alpha, gamma):
    """Voigt cross-section contribution. Ref line_shapes.jl:392."""
    return S * fvoigt(dnu, alpha, gamma)


def chi_phco2(dnu, T):
    """Perrin & Hartmann (1989) sub-Lorentzian chi factor for CO2 far wings.

    Branch-free rewrite of ref line_shapes.jl:467-481: piecewise exponential
    decay with breakpoints at |dnu| = 3, 30, 120 cm^-1 and T-dependent B1, B2.
    """
    adnu = jnp.abs(dnu)
    B1 = 0.0888 - 0.16 * jnp.exp(-0.0041 * T)
    B2 = 0.0526 * jnp.exp(-0.00152 * T)
    chi2 = jnp.exp(-B1 * (adnu - 3.0))
    chi3 = jnp.exp(-B1 * 27.0 - B2 * (adnu - 30.0))
    chi4 = jnp.exp(-B1 * 27.0 - B2 * 90.0 - 0.0232 * (adnu - 120.0))
    return jnp.where(
        adnu < 3.0,
        1.0,
        jnp.where(adnu < 30.0, chi2, jnp.where(adnu < 120.0, chi3, chi4)),
    )


def phco2_xsec(dnu, T, S, alpha, gamma):
    """Sub-Lorentzian CO2 cross-section: Voigt with chi-scaled gamma.

    Ref line_shapes.jl:496-499.
    """
    return voigt_xsec(dnu, S, alpha, chi_phco2(dnu, T) * gamma)
