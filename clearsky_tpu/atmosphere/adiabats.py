"""Adiabatic temperature profiles: dry (closed form) and moist (integrated).

Array-first equivalent of ClearSky.jl ``atmospherics.jl:178-514``. The moist
adiabat integrates the single-condensible lapse equation on a fixed dense grid
in omega = -sqrt(P) coordinates host-side (RK4, replacing the reference's
adaptive Radau — ref atmospherics.jl:441) and evaluates by linear
interpolation, exactly as the reference interpolates its dense output. Both
profile types support an isothermal stratosphere by temperature (``Tstrat``)
or pressure (``Ptropo``) with the reference's cubic-Hermite smoothing patch
(ref atmospherics.jl:482-504). Evaluation is jit/vmap-safe, branch-free.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import R_GAS, P_MIN
from ..utils.grids import logrange, p2omega, omega2p, domega_fac
from ..utils.ode import rk4_dense
from ..utils.rootfind import regula_falsi
from ..utils.interp import interp_linear

__all__ = [
    "lapse_rate_moist",
    "lapse_rate_dry",
    "lapse",
    "DryAdiabat",
    "MoistAdiabat",
    "tropopause",
    "pressure_of_temperature",
]


def lapse_rate_moist(T, P, cpn, cpv, mun, muv, L, psat):
    """General one-condensible moist lapse rate dT/dP. Ref atmospherics.jl:180-192."""
    alpha = psat(T) / P
    Rn = R_GAS / mun
    Rv = R_GAS / muv
    N = 1.0 + alpha * L / (Rn * T)
    D = 1.0 + alpha * (cpv / cpn + (L / (T * Rv) - 1.0) * L / (cpn * T))
    return (T / P) * (Rn / cpn) * (N / D)


def lapse_rate_dry(T, P, cp, mu):
    """Dry adiabatic lapse rate dT/dP. Ref atmospherics.jl:214-216."""
    return (T / P) * (R_GAS / (mu * cp))


def lapse(T, P, cp, mu):
    """Convective adjustment sweep: enforce dT/dP <= dry lapse, surface upward.

    Functional version of the reference's in-place ``lapse!``
    (ref atmospherics.jl:218-232): marching from the highest pressure down,
    each next (lower-pressure) point is WARMED up to the adiabatic
    expectation where the profile is superadiabatic (the reference's "heat
    the upper point if needed"). P may be unsorted; the sweep respects
    descending-pressure order. Host/loop-free jit is not needed — the column
    is short — but the scan keeps it jit-safe.
    """
    T = jnp.asarray(T)
    P = jnp.asarray(P)
    order = jnp.argsort(-P)  # descending pressure
    Ts = T[order]
    Ps = P[order]

    def step(Ti, xs):
        Pi, Pj, Tj = xs
        gamma_e = lapse_rate_dry(Ti, Pi, cp, mu)
        gamma_p = (Tj - Ti) / (Pj - Pi)
        Tj_new = jnp.where(gamma_p > gamma_e, Ti + gamma_e * (Pj - Pi), Tj)
        return Tj_new, Tj_new

    _, adjusted = jax.lax.scan(step, Ts[0], (Ps[:-1], Ps[1:], Ts[1:]))
    out_sorted = jnp.concatenate([Ts[:1], adjusted])
    inv = jnp.argsort(order)
    return out_sorted[inv]


def _smooth_patch(P, Ptropo, smooth, Tstrat, T2, h2, T_raw):
    """Branch-free stratosphere/smoothing logic shared by both adiabats.

    Ref atmospherics.jl:482-504: below Ptropo return Tstrat; inside
    [Ptropo, Ptropo+smooth] a cubic Hermite connection; otherwise the raw
    profile floored at Tstrat.
    """
    psi = (P - Ptropo) / smooth
    hermite = psi**3 * (2 * Tstrat - 2 * T2 + h2) + psi**2 * (-3 * Tstrat + 3 * T2 - h2) + Tstrat
    use_smooth = (Ptropo != 0.0) & (smooth != 0.0) & (P > Ptropo) & (P < Ptropo + smooth)
    T = jnp.where(use_smooth, hermite, jnp.maximum(T_raw, Tstrat))
    return jnp.where(P < Ptropo, jnp.full_like(T, Tstrat), T)


def _check_adiabat(Ts, Ps, Pt, Tstrat, Ptropo, smooth):
    """Ref atmospherics.jl:241-253."""
    if not Ps > Pt:
        raise ValueError("Ps must be greater than Pt")
    if not Pt > 0:
        raise ValueError("Pt must be greater than 0")
    if Tstrat < 0 or Ptropo < 0 or smooth < 0:
        raise ValueError("Tstrat/Ptropo/smooth cannot be negative")
    if Tstrat > 0 and Tstrat >= Ts:
        raise ValueError("Tstrat cannot be greater than Ts")
    if Tstrat != 0 and Ptropo != 0:
        raise ValueError("Cannot have nonzero Tstrat and Ptropo, use one or the other")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class DryAdiabat:
    """Dry adiabat T = Ts (P/Ps)^(R/(mu cp)) with optional isothermal stratosphere.

    Ref atmospherics.jl:290-346. Callable on (possibly batched) pressures.
    """

    Ts: float = dataclasses.field(metadata=dict(static=True))
    Ps: float = dataclasses.field(metadata=dict(static=True))
    Pt: float = dataclasses.field(metadata=dict(static=True))
    cp: float = dataclasses.field(metadata=dict(static=True))
    mu: float = dataclasses.field(metadata=dict(static=True))
    Tstrat: float = dataclasses.field(metadata=dict(static=True))
    Ptropo: float = dataclasses.field(metadata=dict(static=True))
    smooth: float = dataclasses.field(metadata=dict(static=True))
    T2: float = dataclasses.field(metadata=dict(static=True))
    h2: float = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, Ts, Ps, cp, mu, Tstrat=0.0, Ptropo=0.0, smooth=1e2, Pt=P_MIN):
        _check_adiabat(Ts, Ps, Pt, Tstrat, Ptropo, smooth)
        raw = lambda P: Ts * (P / Ps) ** (R_GAS / (mu * cp))
        if Tstrat != 0:
            Ptropo = regula_falsi(lambda P, _: raw(P) - Tstrat, Ps, Pt)
        elif Ptropo != 0:
            Tstrat = raw(Ptropo)
        T2 = h2 = 0.0
        if Ptropo != 0:
            P2 = Ptropo + smooth
            T2 = raw(P2)
            h2 = smooth * lapse_rate_dry(T2, P2, cp, mu)
        return cls(
            Ts=float(Ts), Ps=float(Ps), Pt=float(Pt), cp=float(cp), mu=float(mu),
            Tstrat=float(Tstrat), Ptropo=float(Ptropo), smooth=float(smooth),
            T2=float(T2), h2=float(h2),
        )

    def temperature_raw(self, P):
        """Raw adiabat, no stratosphere adjustment. Ref atmospherics.jl:344."""
        return self.Ts * (jnp.asarray(P) / self.Ps) ** (R_GAS / (self.mu * self.cp))

    def __call__(self, P):
        P = jnp.asarray(P)
        T_raw = self.temperature_raw(P)
        if self.Ptropo == 0.0:
            return jnp.maximum(T_raw, self.Tstrat) if self.Tstrat > 0 else T_raw
        return _smooth_patch(P, self.Ptropo, self.smooth, self.Tstrat, self.T2, self.h2, T_raw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class MoistAdiabat:
    """Single-condensible moist adiabat with optional isothermal stratosphere.

    Ref atmospherics.jl:395-460. Integrated once at construction (host RK4 on
    a dense omega grid, standing in for the reference's adaptive Radau dense
    output) and evaluated by linear interpolation in omega.
    """

    omega: jax.Array
    T: jax.Array
    Ps: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    Pt: float = dataclasses.field(metadata=dict(static=True), default=P_MIN)
    Tstrat: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    Ptropo: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    smooth: float = dataclasses.field(metadata=dict(static=True), default=1e2)
    T2: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    h2: float = dataclasses.field(metadata=dict(static=True), default=0.0)

    @classmethod
    def create(
        cls, Ts, Ps, cpn, cpv, mun, muv, L, psat,
        Tstrat=0.0, Ptropo=0.0, smooth=1e2, N=1000, Pt=P_MIN, substeps=8,
    ):
        _check_adiabat(Ts, Ps, Pt, Tstrat, Ptropo, smooth)

        def dTdomega(w, T, _):
            P = max(w * w, P_MIN)
            return -2.0 * np.sqrt(P) * lapse_rate_moist(T, P, cpn, cpv, mun, muv, L, psat)

        w1, w2 = -np.sqrt(Ps), -np.sqrt(Pt)
        w = logrange(w1, w2, N)
        T = rk4_dense(dTdomega, float(Ts), w, substeps=substeps)
        raw = lambda P: np.interp(-np.sqrt(P), w, T)
        if Tstrat != 0:
            Ptropo = regula_falsi(lambda P, _: raw(P) - Tstrat, Ps, Pt)
        elif Ptropo != 0:
            Tstrat = float(raw(Ptropo))
        T2 = h2 = 0.0
        if Ptropo != 0:
            P2 = Ptropo + smooth
            T2 = float(raw(P2))
            h2 = smooth * lapse_rate_moist(T2, P2, cpn, cpv, mun, muv, L, psat)
        return cls(
            omega=jnp.asarray(w), T=jnp.asarray(T),
            Ps=float(Ps), Pt=float(Pt), Tstrat=float(Tstrat), Ptropo=float(Ptropo),
            smooth=float(smooth), T2=float(T2), h2=float(h2),
        )

    def temperature_raw(self, P):
        """Raw profile interpolated in omega coordinates. Ref atmospherics.jl:462-465."""
        return interp_linear(p2omega(jnp.asarray(P)), self.omega, self.T)

    def __call__(self, P):
        P = jnp.asarray(P)
        T_raw = self.temperature_raw(P)
        if self.Ptropo == 0.0:
            return jnp.maximum(T_raw, self.Tstrat) if self.Tstrat > 0 else T_raw
        return _smooth_patch(P, self.Ptropo, self.smooth, self.Tstrat, self.T2, self.h2, T_raw)


def tropopause(adiabat):
    """(T, P) of the tropopause; requires Tstrat/Ptropo. Ref atmospherics.jl:511-514."""
    if adiabat.Ptropo != 0 and adiabat.Tstrat != 0:
        return adiabat.Tstrat, adiabat.Ptropo
    raise ValueError("no stratosphere temperature or pressure has been defined")


def pressure_of_temperature(adiabat, T):
    """Invert an adiabat: pressure where the raw profile reaches T.

    Ref atmospherics.jl:471-480 (host-side root find).
    """
    Ts = float(adiabat.temperature_raw(adiabat.Ps))
    Tt = float(adiabat.temperature_raw(adiabat.Pt))
    if not (Tt <= T <= Ts):
        raise ValueError(f"temperature {T} K out of adiabat range [{Ts},{Tt}] K")
    return regula_falsi(
        lambda P, _: float(adiabat.temperature_raw(P)) - T, adiabat.Ps, adiabat.Pt
    )
