"""One-shot flux API: optical depth, transmittance, OLR, and full flux packs.

Array-first equivalent of ClearSky.jl ``src/fluxes.jl``. Every entry point
consumes absorbers through dense ``sigma[..., n_nu]`` evaluation and runs the
whole spectrum through the discretized core at once — the reference's
per-wavenumber ``@threads``/``@spawn`` loops (ref fluxes.jl:61,93,152,185,228,270)
become XLA vector parallelism (and mesh sharding, see ``clearsky_tpu.parallel``).

Core selectors:
  * :class:`Discretized` — the reference's default engine (ref shared.jl:55-66).
  * :class:`RadauEq` — adaptive-equivalent engine replacing the reference's
    per-wavenumber adaptive Radau ODE integration (ref shared.jl:40-51,
    ``core/radau.jl``): the same discretized march on a grid refined ``refine``-x
    in sqrt-P coordinates (which concentrate resolution in the upper
    atmosphere exactly like the reference's omega-coordinate ODEs,
    ref util.jl:4-8), with fluxes returned on the caller's levels.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp

from ..ops.planck import planck
from ..atmosphere.profile import formprofile, formprofiles
from ..absorption.absorbers import unify_absorbers, check_pressures
from .discretized import (
    FluxPack,
    lobatto_pressures,
    layer_tau,
    path_tau,
    monoflux,
    outgoing_flux,
    integrate_flux,
)

__all__ = [
    "Discretized",
    "Radau",
    "RadauEq",
    "optical_depth",
    "transmittance",
    "outgoing",
    "monochromatic_fluxes",
    "fluxes",
    "net_fluxes",
    "radiate",
    "top_fluxes",
    "top_imbalance",
    "bottom_fluxes",
]

DEFAULT_THETA_S = 0.841  # stellar zenith angle, cos(theta) ~ 2/3 (ref fluxes.jl:208)


@dataclasses.dataclass(frozen=True)
class Discretized:
    """Layered-core selector. Ref shared.jl:55-66."""

    nstream: int = 5
    nlobatto: int = 2


@dataclasses.dataclass(frozen=True)
class Radau:
    """Adaptive-core selector: on-device error-controlled Radau IIA(5) marches.

    The real counterpart of the reference's ``Radau(nstream, tol)`` engine
    (ref shared.jl:40-51, core/radau.jl) — per-(stream x wavenumber) adaptive
    Schwarzschild integration (see ``rt.radau``). ``nlevels`` sets the
    internal opacity-cache resolution for non-accelerated absorber stacks
    (0 = an AcceleratedAbsorber's own grid, else 256 omega-spaced points).

    **Role: error-controlled cross-checks, not production loops.** Every
    lane in the batched ``lax.while_loop`` pays for the stiffest lane's step
    count (lane divergence up to ~70x the mean step count), so it costs
    orders of magnitude more than the discretized core at the same
    configuration. Use it to validate a configuration
    against an independent integrator with an explicit error tolerance; for
    production accuracy needs, refine the grid instead via ``RadauEq`` or a
    larger ``radmul`` — the discretized core converges under refinement
    (tests/test_rce_oracle.py: radmul 2->4 error ratio 0.31).
    """

    nstream: int = 5
    tol: float = 1e-5
    nlevels: int = 0
    max_steps: int = 10_000


@dataclasses.dataclass(frozen=True)
class RadauEq:
    """Adaptive-equivalent selector: grid-refined discretized core.

    Replaces the reference's ``Radau(nstream, tol)`` adaptive engine
    (ref shared.jl:40-51); ``refine`` sub-layers per caller layer, spaced in
    sqrt-P, stand in for adaptive step control.
    """

    nstream: int = 5
    nlobatto: int = 3
    refine: int = 8


def _check_azimuth(theta):
    if not (0 <= theta < np.pi / 2):
        raise ValueError("zenith angle theta must be in [0, pi/2)")


def _check_streams(n):
    if n < 4:
        warnings.warn("careful! using nstream < 4 is likely to be inaccurate!")


def _spectral_fn(x):
    """Normalize a spectral input (scalar or f(nu)) to f(nu) -> [n_nu]."""
    if callable(x):
        return lambda nu: jnp.broadcast_to(jnp.asarray(x(nu)), jnp.shape(nu))
    return lambda nu: jnp.full(jnp.shape(nu), jnp.asarray(x))


def _eval_profiles(Pn, fT, fmu):
    Tn = jnp.broadcast_to(jnp.asarray(fT(Pn)), Pn.shape)
    mun = jnp.broadcast_to(jnp.asarray(fmu(Tn, Pn)), Pn.shape)
    return Tn, mun


def _column_tau(P, g, fT, fmu, A, nlobatto, floor=False):
    """tau[np-1, n_nu] on an ascending pressure column.

    sigma is evaluated FLAT ([np-1 * nlobatto, n_nu]) and the Lobatto
    quadrature is one static block-diagonal matmul (see
    :func:`rt.discretized.layer_tau_flat`).
    """
    from .discretized import layer_tau_flat

    Pn = lobatto_pressures(P, nlobatto)            # [np-1, k]
    Pf = Pn.reshape(-1)
    Tf, muf = _eval_profiles(Pf, fT, fmu)
    sig = A.sigma(Tf, Pf)                          # [L*k, n_nu] flat
    return layer_tau_flat(P, muf, sig, g, nlobatto, floor=floor)


def _omega_grid(P1, P2, n):
    """Dense internal grid between two pressures, spaced in omega = -sqrt(P).

    Stands in for the reference's adaptive integration path between two
    pressure levels (ref fluxes.jl:39-66), resolving the upper atmosphere the
    same way the omega-coordinate ODEs do.
    """
    hi, lo = max(P1, P2), min(P1, P2)
    w = np.linspace(np.sqrt(lo), np.sqrt(hi), n)
    P = w * w  # ascending pressures
    # pin the endpoints: the sqrt round trip can overshoot the caller's
    # pressures by ~1e-11 relative, which the strict table-domain guard rejects
    P[0], P[-1] = lo, hi
    return P


def _planck_levels(P, nu, fT):
    T = jnp.broadcast_to(jnp.asarray(fT(P)), jnp.shape(P))
    return planck(nu[None, :], T[:, None])


def _refined(P, refine):
    """Insert `refine-1` sqrt-P-spaced interior levels per layer; return
    (P_refined, indices of the original levels)."""
    P = np.asarray(P, dtype=np.float64)
    L = len(P) - 1
    out = []
    for i in range(L):
        w = np.linspace(np.sqrt(P[i]), np.sqrt(P[i + 1]), refine + 1)[:-1]
        out.append(w * w)
    Pr = np.concatenate(out + [P[-1:]])
    idx = np.arange(0, L * refine + 1, refine)
    return Pr, idx


def optical_depth(
    P, g, T, mu, theta, *absorbers, nlobatto: int = 4, nlevels: int = 128,
    core=None, Ptop: float = 1.0
):
    """Monochromatic slant-path optical depths [n_nu] between two pressures.

    Two call forms, mirroring the reference:
      * ``optical_depth((P1, P2), ...)`` or two scalars via a 2-tuple — dense
        internal omega grid (the Radau-path equivalent, ref fluxes.jl:39-66);
        a single scalar integrates from that pressure to ``Ptop`` (1 Pa by
        default, as in ``outgoing``);
      * ``optical_depth(P_vector, ...)`` — Lobatto quadrature on the given
        levels (ref fluxes.jl:68-97).

    ``core=Radau(...)`` integrates the depth ODE adaptively instead (the
    reference Radau path proper, ref core/radau.jl:76-110).
    """
    A = unify_absorbers(absorbers)
    _check_azimuth(theta)
    if core is not None and not isinstance(core, Radau):
        raise ValueError(
            "optical_depth supports core=None (Lobatto quadrature) or "
            f"core=Radau(...); got {core!r}"
        )
    P = np.asarray(P, dtype=np.float64)
    if P.ndim == 0 or len(P) == 2:
        P1, P2 = (float(P), float(Ptop)) if P.ndim == 0 else (float(P[0]), float(P[1]))
        Pgrid = _omega_grid(P1, P2, nlevels)
    else:
        Pgrid = np.sort(P)
    check_pressures(A, Pgrid[-1], Pgrid[0])
    fT, fmu = formprofiles(jnp.asarray(Pgrid), T, mu)
    m = 1.0 / np.cos(theta)
    if isinstance(core, Radau):
        from .radau import build_column_cache, radau_path_tau

        cache = build_column_cache(Pgrid, fT, fmu, A, nlevels=core.nlevels)
        return radau_path_tau(
            cache, Pgrid[0], Pgrid[-1], g, m=m, tol=core.tol,
            max_steps=core.max_steps,
        )
    Pg = jnp.asarray(Pgrid)
    Pn = lobatto_pressures(Pg, nlobatto)
    Tn, mun = _eval_profiles(Pn, fT, fmu)
    sig = A.sigma(Tn, Pn)
    return path_tau(Pg, Tn, mun, sig, g, m, nlobatto)


def transmittance(*args, **kwargs):
    """exp(-optical_depth(...)). Ref fluxes.jl:109."""
    return jnp.exp(-optical_depth(*args, **kwargs))


def outgoing(
    P,
    g,
    T,
    mu,
    *absorbers,
    Ptop: float = 1.0,
    nstream: int = 5,
    nlobatto: int = 3,
    nlevels: int = 128,
    vertical: bool = False,
    core=None,
):
    """Outgoing monochromatic flux at TOA [n_nu] (OLR spectrum).

    Mirrors the working reference semantics (Radau path, ref fluxes.jl:133-158):
    surface Planck emission marched up through the column with ``nstream``
    hemispheric streams; integrate with ``trapz(nu, olr)`` for total OLR.
    Accepts a scalar surface pressure (internal omega grid down to ``Ptop``)
    or a full pressure vector. Pass ``core=Radau(...)`` for the adaptive
    error-controlled engine instead of the discretized march.
    """
    A = unify_absorbers(absorbers)
    # a core selector bundles its own quadrature orders (as in the
    # reference's Radau(nstream, tol) / Discretized(...), ref shared.jl:40-66)
    # — it overrides this function's nstream/nlobatto arguments
    if isinstance(core, Discretized):
        nstream, nlobatto = core.nstream, core.nlobatto
    elif isinstance(core, RadauEq):
        nstream, nlobatto = core.nstream, core.nlobatto
    elif core is not None and not isinstance(core, Radau):
        raise ValueError(f"unknown core selector {core!r}")
    _check_streams(nstream)
    P = np.asarray(P, dtype=np.float64)
    if P.ndim == 0:
        nlev = nlevels * (core.refine if isinstance(core, RadauEq) else 1)
        Pgrid = P_base = _omega_grid(float(P), Ptop, nlev)
    else:
        P_base = np.sort(P)  # vector T/mu interpolate against the CALLER's levels
        Pgrid = (
            _refined(P_base, core.refine)[0]
            if isinstance(core, RadauEq)
            else P_base
        )
    check_pressures(A, Pgrid[-1], Pgrid[0])
    Pg = jnp.asarray(Pgrid)
    fT, fmu = formprofiles(jnp.asarray(P_base), T, mu)
    if isinstance(core, Radau):
        _check_streams(core.nstream)
        from .radau import build_column_cache, radau_outgoing

        cache = build_column_cache(Pgrid, fT, fmu, A, nlevels=core.nlevels)
        return radau_outgoing(
            cache, Pgrid[-1], Pgrid[0], g, nstream=core.nstream,
            tol=core.tol, vertical=vertical, max_steps=core.max_steps,
        )
    tau = _column_tau(Pg, g, fT, fmu, A, nlobatto)
    B = _planck_levels(Pg, A.nu, fT)
    return outgoing_flux(tau, B, nstream, vertical=vertical)


def monochromatic_fluxes(
    P,
    g,
    T,
    mu,
    fS,
    fa,
    *absorbers,
    core=Discretized(),
    theta_s: float = DEFAULT_THETA_S,
):
    """Whole-column monochromatic fluxes (M_up, M_down, tau). Ref fluxes.jl:195-306.

    P must be ascending [Pa]; T/mu may be vectors on P, scalars, or callables;
    fS(nu) is the incoming stellar spectral flux at TOA, fa(nu) surface albedo.
    """
    A = unify_absorbers(absorbers)
    _check_streams(core.nstream)
    _check_azimuth(theta_s)
    P = np.asarray(P, dtype=np.float64)
    if np.any(np.diff(P) <= 0):
        raise ValueError("pressure coordinates must be in ascending order (sorted)")
    check_pressures(A, P[-1], P[0])
    fT, fmu = formprofiles(jnp.asarray(P), T, mu)
    fS_ = _spectral_fn(fS)
    fa_ = _spectral_fn(fa)
    S_nu = fS_(A.nu)
    a_nu = fa_(A.nu)

    if isinstance(core, Radau):
        from .radau import build_column_cache, radau_monoflux

        cache = build_column_cache(P, fT, fmu, A, nlevels=core.nlevels)
        return radau_monoflux(
            cache, P, g, S_nu, a_nu, theta_s,
            nstream=core.nstream, tol=core.tol, max_steps=core.max_steps,
        )

    if isinstance(core, RadauEq):
        Pr, idx = _refined(P, core.refine)
        Pr_j = jnp.asarray(Pr)
        tau_r = _column_tau(Pr_j, g, fT, fmu, A, core.nlobatto)
        B_r = _planck_levels(Pr_j, A.nu, fT)
        M_up_r, M_down_r = monoflux(tau_r, B_r, A.nu, S_nu, a_nu, theta_s, core.nstream)
        M_up, M_down = M_up_r[idx], M_down_r[idx]
        # aggregate refined sub-layer depths back onto caller layers
        tau = tau_r.reshape(len(P) - 1, core.refine, -1).sum(axis=1)
        return M_up, M_down, tau

    Pg = jnp.asarray(P)
    tau = _column_tau(Pg, g, fT, fmu, A, core.nlobatto)
    B = _planck_levels(Pg, A.nu, fT)
    M_up, M_down = monoflux(tau, B, A.nu, S_nu, a_nu, theta_s, core.nstream)
    return M_up, M_down, tau


def radiate(
    P,
    g,
    T,
    mu,
    fS,
    fa,
    *absorbers,
    core=Discretized(),
    theta_s: float = DEFAULT_THETA_S,
) -> FluxPack:
    """Full radiation pack: monochromatic + spectrally integrated fluxes.

    Ref fluxes.jl:355-404 (``radiate!``/``radiate``).
    """
    A = unify_absorbers(absorbers)
    M_up, M_down, tau = monochromatic_fluxes(
        P, g, T, mu, fS, fa, A, core=core, theta_s=theta_s
    )
    F_up, F_down = integrate_flux(M_up, M_down, A.nu)
    return FluxPack(tau, M_up, M_down, F_up, F_down, F_up - F_down)


def fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """(F_up, F_down) spectrally integrated flux profiles. Ref fluxes.jl:311-340."""
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_up, F.F_down


def net_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """F_up - F_down. Ref fluxes.jl:342-352."""
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_net


def top_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """(outgoing, incoming) top-of-atmosphere spectrally integrated fluxes.

    The reference documents ``topfluxes`` (docs/modeling.md upstream; the
    symbol never shipped in its source). Includes reflected stellar radiation
    through the Lambertian surface, unlike ``outgoing``.
    """
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_up[0], F.F_down[0]


def top_imbalance(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """Net TOA imbalance: outgoing - incoming (positive = net cooling)."""
    up, dn = top_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return up - dn


def bottom_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """(upward, downward) surface spectrally integrated fluxes
    (the reference's documented ``bottomfluxes``)."""
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_up[-1], F.F_down[-1]
