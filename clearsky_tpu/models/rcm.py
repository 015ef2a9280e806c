"""Radiative-convective model: the time-stepping column model.

Array-first re-design of ClearSky.jl ``src/radiative_convective.jl``. The
reference mutates an RCM struct in place (``heating!``/``step!``/``jacobian!``);
here the model is a frozen pytree and every operation is a pure function —
``heating`` jits to a single fused device program over the whole spectrum,
``step_n``/``run`` scan over time steps on device, and ``jacobian`` uses
``jax.jacfwd`` through the entire radiation calculation (replacing the
reference's np+1 finite-difference sweeps, ref radiative_convective.jl:154-171;
a finite-difference mode is kept for parity testing).

Matching the reference's contract (ref radiative_convective.jl:146-151 and the
note in SURVEY.md §3.4): a bare ``step`` does NOT refresh cached cross-sections
nor apply convective adjustment — those are explicit, composable pieces
(:func:`update_absorber`, :func:`convective_adjustment`) that :func:`run`
wires together with user-chosen cadences.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.planck import planck
from ..utils.interp import interp_linear
from ..utils.grids import trapz
from ..absorption.absorbers import AcceleratedAbsorber, unify_absorbers
from ..atmosphere.adiabats import lapse
from ..rt.discretized import (
    layer_tau_flat,
    FluxPack,
    lobatto_pressures,
    monoflux,
    integrate_flux,
)
from ..rt.fluxes import Discretized, Radau, RadauEq, DEFAULT_THETA_S, _spectral_fn

__all__ = [
    "RCM",
    "heating",
    "step",
    "step_n",
    "run",
    "jacobian",
    "update_absorber",
    "convective_adjustment",
    "radiative_grid",
]


def radiative_grid(Pe: np.ndarray, radmul: int) -> np.ndarray:
    """Refined radiative grid: each edge layer split into ``radmul`` equal parts.

    Equivalent to the reference's weighted-average interleaving
    (ref radiative_convective.jl:70-85), which is exactly linear subdivision of
    every [Pe_i, Pe_{i+1}] interval; we accept any radmul >= 1 (the reference
    restricts to even or 1 only because of how it fills the array).
    """
    Pe = np.asarray(Pe, dtype=np.float64)
    if radmul < 1:
        raise ValueError("radmul must be a positive integer")
    if radmul == 1:
        return Pe.copy()
    sub = np.linspace(Pe[:-1], Pe[1:], radmul, endpoint=False, axis=1).ravel()
    return np.concatenate([sub, Pe[-1:]])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class RCM:
    """Radiative-convective column model state. Ref radiative_convective.jl:1-103.

    Leaves: edge pressures ``Pe`` [np], cell-center pressures ``P`` [np]
    (last entry = surface), prognostic temperatures ``T`` [np], refined
    radiative grid ``Pr`` [nrad], the cached absorber ``A``, and the
    spectral boundary conditions ``S_nu``/``a_nu`` [n_nu].

    Static: gravity ``g``, surface heat capacity ``cs``, the mean-molar-mass
    and heat-capacity closures ``fmu(T, P)``/``fcp(T, P)``, stellar zenith
    angle ``theta_s``, and the numerical core selector.
    """

    Pe: jax.Array
    P: jax.Array
    T: jax.Array
    Pr: jax.Array
    A: AcceleratedAbsorber
    S_nu: jax.Array
    a_nu: jax.Array
    g: float = dataclasses.field(metadata=dict(static=True), default=9.8)
    cs: float = dataclasses.field(metadata=dict(static=True), default=1e7)
    theta_s: float = dataclasses.field(metadata=dict(static=True), default=DEFAULT_THETA_S)
    fmu: Callable = dataclasses.field(metadata=dict(static=True), default=None)
    fcp: Callable = dataclasses.field(metadata=dict(static=True), default=None)
    core: Discretized = dataclasses.field(metadata=dict(static=True), default=Discretized())

    @classmethod
    def create(
        cls,
        Pe,
        Te,
        g,
        fmu,
        fS,
        fa,
        fcp,
        cs,
        *absorbers,
        core=Discretized(),
        radmul: int = 2,
        theta_s: float = DEFAULT_THETA_S,
    ) -> "RCM":
        """Construct from edge grids and physics closures. Ref radiative_convective.jl:42-103."""
        Pe = np.asarray(Pe, dtype=np.float64)
        Te = np.asarray(Te, dtype=np.float64)
        # validate BEFORE the paired argsort indexing: a longer Te would be
        # silently truncated by Te[idx] and a shorter one would raise a raw
        # IndexError instead of this message
        if len(Pe) != len(Te):
            raise ValueError(
                "must have same number of initial temperature and pressure values"
            )
        idx = np.argsort(Pe)
        Pe, Te = Pe[idx], Te[idx]
        # cell centers; the last cell is the surface itself (ref :64-70)
        P = np.concatenate([0.5 * (Pe[:-1] + Pe[1:]), Pe[-1:]])
        T = np.concatenate([0.5 * (Te[:-1] + Te[1:]), Te[-1:]])
        Pr = radiative_grid(Pe, radmul)
        if isinstance(core, RadauEq):
            # the adaptive-equivalent core = the discretized march on a
            # refine-x sqrt-P-subdivided grid (rt/fluxes.py); heating's
            # fall-through branch then uses core.nstream/nlobatto as-is
            from ..rt.fluxes import _refined

            Pr, _ = _refined(Pr, core.refine)
        stack = unify_absorbers(absorbers)
        A = AcceleratedAbsorber.create(jnp.asarray(Te), jnp.asarray(Pe), stack)
        S_nu = _spectral_fn(fS)(A.nu)
        a_nu = _spectral_fn(fa)(A.nu)
        if not callable(fmu) or not callable(fcp):
            raise TypeError("fmu and fcp must be callables (T, P) -> value")
        return cls(
            Pe=jnp.asarray(Pe),
            P=jnp.asarray(P),
            T=jnp.asarray(T),
            Pr=jnp.asarray(Pr),
            A=A,
            S_nu=S_nu,
            a_nu=a_nu,
            g=float(g),
            cs=float(cs),
            theta_s=float(theta_s),
            fmu=fmu,
            fcp=fcp,
            core=core,
        )

    @property
    def n_cells(self) -> int:
        return self.P.shape[0]

    @property
    def nu(self) -> jax.Array:
        return self.A.nu

    def __repr__(self):  # pragma: no cover - cosmetic
        Pe = np.asarray(self.Pe)
        nu = np.asarray(self.nu)
        T = np.asarray(self.T)
        return (
            f"RCM(np={len(Pe)}, g={self.g} m/s^2, "
            f"P in [{Pe.min():.4g}, {Pe.max():.4g}] Pa, "
            f"nu in [{nu.min():.4g}, {nu.max():.4g}] cm^-1 ({len(nu)} pts), "
            f"T in [{T.min():.4g}, {T.max():.4g}] K)"
        )


def _mono_on_radiative_grid(rcm: RCM, T, A: AcceleratedAbsorber):
    """Monochromatic fluxes (tau, M_up, M_down) on the refined grid for cell temps T."""
    lnP = jnp.log(rcm.P)

    def fT(P):
        return interp_linear(jnp.log(P), lnP, T)

    core = rcm.core
    if isinstance(core, Radau):
        # adaptive engine on the refined grid: opacity from the accelerated
        # cache, T/mu re-sampled onto its lnP grid (the reference's RCM Radau
        # path pulls through the same AcceleratedAbsorber interpolation,
        # ref absorbers.jl:203 + radiative_convective.jl:113)
        from ..rt.radau import build_column_cache, radau_monoflux

        cache = build_column_cache(rcm.Pr, fT, rcm.fmu, A)
        M_up, M_down, tau = radau_monoflux(
            cache, rcm.Pr, rcm.g, rcm.S_nu, rcm.a_nu, rcm.theta_s,
            nstream=core.nstream, tol=core.tol, max_steps=core.max_steps,
        )
        return tau, M_up, M_down
    # FLAT node evaluation + block-diagonal quadrature matmul (see
    # rt.discretized.layer_tau_flat)
    Pn = lobatto_pressures(rcm.Pr, core.nlobatto)
    Pf = Pn.reshape(-1)
    Tf = fT(Pf)
    muf = jnp.broadcast_to(jnp.asarray(rcm.fmu(Tf, Pf)), Pf.shape)
    sig = A.sigma(Tf, Pf)
    tau = layer_tau_flat(rcm.Pr, muf, sig, rcm.g, core.nlobatto)
    B = planck(rcm.nu[None, :], fT(rcm.Pr)[:, None])
    M_up, M_down = monoflux(
        tau, B, rcm.nu, rcm.S_nu, rcm.a_nu, rcm.theta_s, core.nstream
    )
    return tau, M_up, M_down


def _flux_on_radiative_grid(rcm: RCM, T, A: AcceleratedAbsorber):
    """Monochromatic + integrated fluxes on the refined grid for cell temps T."""
    tau, M_up, M_down = _mono_on_radiative_grid(rcm, T, A)
    F_up, F_down = integrate_flux(M_up, M_down, rcm.nu)
    return FluxPack(tau, M_up, M_down, F_up, F_down, F_up - F_down)


def _heating_operator(rcm, T):
    """The linear map G: M_net[nr, n_nu] -> H rows, built per-nu.

    Algebraically, heating is interp(lnPr -> lnPe) o level-difference o
    scale, applied to the spectrally integrated net flux. Applying that
    linear map BEFORE the spectral integral is mathematically identical but
    far better conditioned in float32: F_net is O(100) W/m^2 while its
    adjacent-level differences are O(0.1-1), so integrate-then-difference
    amplifies the integral's rounding ~100-1000x. Measured on the config-4
    column: f32 heating error 2.4% of peak (at the equilibrium state) the
    old way, which shifted the f32 quasi-steady state by ~12 K in the
    convective-boundary levels; difference-then-integrate brings f32
    heating to the ~1e-4-of-peak class (BASELINE.md round 4).

    Rows 0..np-2 are the cell heating weights (g/cp * dInterp / dP, with
    the reference's sign flip, ref radiative_convective.jl:115-124); the
    last row is the surface term (interp row at Pe[-1], scaled 1/cs).
    """
    lnPe, lnPr = jnp.log(rcm.Pe), jnp.log(rcm.Pr)
    nr = rcm.Pr.shape[0]
    npe = rcm.Pe.shape[0]
    i = jnp.clip(jnp.searchsorted(lnPr, lnPe, side="right") - 1, 0, nr - 2)
    t = (lnPe - lnPr[i]) / (lnPr[i + 1] - lnPr[i])
    rows = jnp.arange(npe)
    W = jnp.zeros((npe, nr), dtype=rcm.Pr.dtype)
    W = W.at[rows, i].add(-(1.0 - t)).at[rows, i + 1].add(-t)  # R = -interp
    cp = jnp.asarray(rcm.fcp(T[:-1], rcm.P[:-1]))
    dP = rcm.Pe[1:] - rcm.Pe[:-1]
    Gc = (W[:-1] - W[1:]) * ((rcm.g / cp) / dP)[:, None]
    Gs = W[-1:] / rcm.cs
    return jnp.concatenate([Gc, Gs])


def heating(rcm: RCM, T=None, A: AcceleratedAbsorber | None = None, spectral_sum=None):
    """Cell heating rates H [K/s] (last entry = surface). Ref radiative_convective.jl:108-144.

    Pure function of the temperature state: radiates on the refined grid,
    applies the interp/difference/scale operator to the PER-WAVENUMBER net
    flux (see :func:`_heating_operator` — difference-then-integrate is the
    f32-conditioning-critical order), and spectrally integrates the result.

    ``spectral_sum`` optionally replaces the spectral trapz integral
    ``y[..., n_nu] -> [...]`` — the hook the sharded path uses to turn the one
    cross-shard reduction into a ``psum`` (see ``clearsky_tpu.parallel``).
    """
    T = rcm.T if T is None else T
    A = rcm.A if A is None else A
    _, M_up, M_down = _mono_on_radiative_grid(rcm, T, A)
    G = _heating_operator(rcm, T)
    # HIGHEST: a default-precision f32 matmul may run in TF32 on the GPU
    # and put a ~1e-3 error class right back into the heating
    dH = jnp.matmul(G, M_up - M_down,
                    precision=jax.lax.Precision.HIGHEST)  # [np, n_nu]
    if spectral_sum is None:
        return trapz(rcm.nu, dH, axis=-1)
    return spectral_sum(dH)


def radiate_state(rcm: RCM) -> FluxPack:
    """FluxPack on the refined radiative grid for the current state."""
    return _flux_on_radiative_grid(rcm, rcm.T, rcm.A)


def step(rcm: RCM, dt) -> RCM:
    """One explicit-Euler step T <- T + dt*H. Ref radiative_convective.jl:146-151.

    Does NOT refresh cross-sections or adjust convection — compose with
    :func:`update_absorber` / :func:`convective_adjustment` (or use :func:`run`).
    """
    H = heating(rcm)
    return dataclasses.replace(rcm, T=rcm.T + dt * H)


def update_absorber(rcm: RCM, Te=None) -> RCM:
    """Refresh the cached cross-sections for the current temperatures.

    Equivalent of the reference's user-invoked ``update!(𝒜, T)``
    (ref absorbers.jl:173-200): edge temperatures are interpolated from the
    prognostic cell temperatures unless given explicitly.
    """
    if Te is None:
        Te = interp_linear(jnp.log(rcm.Pe), jnp.log(rcm.P), rcm.T)
    return dataclasses.replace(rcm, A=rcm.A.update(Te))


def convective_adjustment(rcm: RCM, cp: float, mu: float) -> RCM:
    """Dry convective adjustment of the prognostic temperatures.

    The reference exposes ``lapse!`` for the user's RCE loop
    (ref atmospherics.jl:218-232); this applies it to the cell column.
    """
    return dataclasses.replace(rcm, T=lapse(rcm.T, rcm.P, cp, mu))


def step_n(rcm: RCM, dt, nsteps: int) -> RCM:
    """``nsteps`` Euler steps as one on-device ``lax.scan`` (no absorber refresh)."""

    def body(T, _):
        H = heating(rcm, T)
        return T + dt * H, None

    T, _ = lax.scan(body, rcm.T, None, length=nsteps)
    return dataclasses.replace(rcm, T=T)


def run(
    rcm: RCM,
    dt,
    nsteps: int,
    update_every: int = 0,
    adjust_every: int = 0,
    cp: float | None = None,
    mu: float | None = None,
    record_every: int = 0,
    spectral_sum=None,
):
    """Full RCE integration: Euler steps with cross-section refresh and
    convective-adjustment cadences, scanned on device.

    This is the composed loop the reference leaves to the user (SURVEY.md §3.4):
    ``step -> update sigma (every update_every) -> lapse adjust (every
    adjust_every)``. Returns ``(rcm_final, history)`` where history is the
    recorded temperature trajectory [nrec, np] (empty if record_every == 0).
    """
    if adjust_every and (cp is None or mu is None):
        raise ValueError("convective adjustment requires scalar cp and mu")
    lnPe, lnP = jnp.log(rcm.Pe), jnp.log(rcm.P)

    def body(carry, i):
        T, A = carry
        H = heating(rcm, T, A, spectral_sum=spectral_sum)
        T = T + dt * H
        if adjust_every:
            T = lax.cond(
                (i + 1) % adjust_every == 0,
                lambda t: lapse(t, rcm.P, cp, mu),
                lambda t: t,
                T,
            )
        if update_every:
            Te = interp_linear(lnPe, lnP, T)
            A = lax.cond(
                (i + 1) % update_every == 0,
                lambda a: a.update(Te),
                lambda a: a,
                A,
            )
        return (T, A), None

    def chunk(carry, i0):
        # inner scan over one recording interval, emitting ONE snapshot —
        # stacking every step's T and subsampling after the scan would
        # allocate [nsteps, np] on device (hundreds of MB for long runs)
        # for recs that are then 1/record_every discarded
        carry, _ = lax.scan(body, carry, i0 + jnp.arange(record_every))
        return carry, carry[0]

    carry = (rcm.T, rcm.A)
    if record_every:
        n_out = nsteps // record_every
        carry, recs = lax.scan(
            chunk, carry, jnp.arange(n_out) * record_every
        )
        tail = nsteps - n_out * record_every
    else:
        recs = jnp.zeros((0, rcm.T.shape[0]), rcm.T.dtype)
        tail = nsteps
    if tail:
        carry, _ = lax.scan(body, carry, nsteps - tail + jnp.arange(tail))
    T, A = carry
    out = dataclasses.replace(rcm, T=T, A=A)
    return out, recs


def jacobian(rcm: RCM, mode: str = "fwd", eps: float = 1.0,
             update_sigma: bool = False):
    """Jacobian dH/dT [np, np] of the heating rates w.r.t. cell temperatures.

    ``mode='fwd'`` differentiates the whole radiation calculation with
    ``jax.jacfwd`` — exact, one compiled program. ``mode='fd'`` reproduces the
    reference's one-sided finite differences with perturbation ``eps``
    (ref radiative_convective.jl:153-171) for parity testing.

    ``update_sigma=True`` additionally differentiates through the absorber
    refresh — the d(sigma)/dT dependence the reference's Jacobian cannot see
    (its heating! radiates with frozen cached cross-sections). With a
    DirectGas/MultiGas this propagates tangents through the Voigt line sum
    itself: on the GPU via the line-sum kernel's custom JVP
    (``ops.linesum_gpu``), whose tangent runs the plain path.
    """
    lnPe, lnP = jnp.log(rcm.Pe), jnp.log(rcm.P)

    def H_of_T(T):
        if update_sigma:
            A = rcm.A.update(interp_linear(lnPe, lnP, T))
            return heating(rcm, T, A)
        return heating(rcm, T)

    if mode == "fwd":
        return jax.jacfwd(H_of_T)(rcm.T)
    if mode == "fd":
        H0 = H_of_T(rcm.T)
        n = rcm.n_cells
        eye = jnp.eye(n, dtype=rcm.T.dtype)
        cols = jax.vmap(lambda v: (H_of_T(rcm.T + eps * v) - H0) / eps)(eye)
        return cols.T
    raise ValueError("mode must be 'fwd' or 'fd'")
