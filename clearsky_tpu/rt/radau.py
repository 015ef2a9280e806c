"""Adaptive Radau flux core: per-lane error-controlled Schwarzschild marches.

On-device equivalent of the reference's second flux engine
(ClearSky.jl ``src/core/radau.jl``): optical depth and intensity ODEs in the
omega/iota sqrt-pressure coordinates (ref util.jl:4-14), integrated by the
batched adaptive Radau IIA(5) engine (``utils.radau``) — every (stream x
wavenumber) lane marches with its own adaptive step size inside one
``lax.while_loop``, replacing the reference's one-task-per-wavenumber
``@spawn`` loops (ref fluxes.jl:61,152,228).

Like the reference's Radau path — which pulls cross-sections through
interpolators (``OpacityTable`` per wavenumber, or the RCM's
``AcceleratedAbsorber`` lnP interpolation, ref absorbers.jl:203) — this engine
consumes a **column opacity cache**: log cross-sections on a pressure grid,
interpolated linearly in lnP at the integrator's query points (with the
temperature and mean-molar-mass profiles cached on the same grid). An
``AcceleratedAbsorber`` is consumed as-is; any other absorber stack is
densely evaluated once on a fine omega-spaced internal grid (array-push, one
device call) before integration starts.

The production engine remains the discretized core (SURVEY.md §7.0 — the
linear-in-tau march is the exact exponential integrator); this core exists
for capability parity and as an on-device error-controlled cross-check. Both
engines are validated against the analytic gray-gas OLR and each other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..constants import N_AVOGADRO
from ..ops.planck import planck
from ..utils.quadrature import stream_nodes
from ..utils.radau import radau_scalar, radau_dense
from ..absorption.absorbers import AcceleratedAbsorber, _LOG_TINY

__all__ = [
    "ColumnCache",
    "build_column_cache",
    "radau_path_tau",
    "radau_outgoing",
    "radau_monoflux",
]


class ColumnCache(NamedTuple):
    """Opacity/state column for the adaptive core (ascending pressure grid).

    The analogue of the reference Radau path's interpolator bundle: log
    cross-sections plus T/mu profiles, all linear-in-lnP (ref absorbers.jl:203,
    atmospherics.jl:6-26)."""

    lnP: jnp.ndarray       # [npc]
    T: jnp.ndarray         # [npc]
    mu: jnp.ndarray        # [npc]
    ln_sigma: jnp.ndarray  # [npc, n_nu]
    nu: jnp.ndarray        # [n_nu]


def build_column_cache(P, fT, fmu, A, nlevels: int = 0) -> ColumnCache:
    """Evaluate the absorber/profiles onto a column cache.

    ``A`` may be an :class:`AcceleratedAbsorber` (its own cached grid is used
    unless ``nlevels`` forces a finer one) or any absorber stack — then a
    dense sigma evaluation runs once on an omega-spaced grid of ``nlevels``
    (default 256) points spanning [P.min, P.max].
    """
    if isinstance(A, AcceleratedAbsorber) and nlevels == 0:
        # P is unused here, so this branch stays trace-safe (RCM heating
        # builds the cache inside jit with a traced pressure grid)
        lnP = A.lnP
        Pg = jnp.exp(lnP)
        T = jnp.broadcast_to(jnp.asarray(fT(Pg)), Pg.shape)
        mu = jnp.broadcast_to(jnp.asarray(fmu(T, Pg)), Pg.shape)
        return ColumnCache(lnP=lnP, T=T, mu=mu, ln_sigma=A.ln_sigma, nu=A.nu)
    P = np.asarray(P, dtype=np.float64)
    n = nlevels or 256
    w = np.linspace(np.sqrt(P.min()), np.sqrt(P.max()), n)
    Pg = w * w
    Pg[0], Pg[-1] = P.min(), P.max()
    Pg = jnp.asarray(Pg)
    T = jnp.broadcast_to(jnp.asarray(fT(Pg)), Pg.shape)
    mu = jnp.broadcast_to(jnp.asarray(fmu(T, Pg)), Pg.shape)
    sig = A.sigma(T, Pg)  # [n, n_nu] — one dense array-push evaluation
    ln = jnp.where(
        sig > 0, jnp.log(jnp.maximum(sig, jnp.finfo(sig.dtype).tiny)), _LOG_TINY
    )
    # (log(max(sig, tiny)) >= _LOG_TINY already; no second floor needed)
    return ColumnCache(lnP=jnp.log(Pg), T=T, mu=mu, ln_sigma=ln, nu=A.nu)


def _bracket(lnp, lnPg):
    """Edge-extrapolating linear-interp bracket (matches utils.interp)."""
    npc = lnPg.shape[0]
    i = jnp.clip(jnp.searchsorted(lnPg, lnp, side="right") - 1, 0, npc - 2)
    t = (lnp - lnPg[i]) / (lnPg[i + 1] - lnPg[i])
    return i, t


# The RHS functions are MODULE-LEVEL and take the whole column cache through
# the traced args pytree: radau_scalar's jit cache keys on the RHS identity,
# and per-call closures would force a full while-loop recompile on every
# top-level flux call (the while loop is the largest program in the
# package to compile).
# x is the signed sqrt-P coordinate (omega upward / iota downward, ref
# util.jl:4-14); the path element is |dP| = 2 sqrt(P) |dx| in both directions.


def _rhs_emission(x, y, args):
    """Schwarzschild along the propagation path: dI/dx = rate * (B - I)."""
    nu_idx, nu_val, m, lnPg, Tg, mug, lnsig_flat, const, n_nu = args
    sp = jnp.abs(x)
    lnp = 2.0 * jnp.log(sp)
    i, t = _bracket(lnp, lnPg)
    T = Tg[i] + t * (Tg[i + 1] - Tg[i])
    mu = mug[i] + t * (mug[i + 1] - mug[i])
    base = i * n_nu + nu_idx
    lns = lnsig_flat[base] + t * (lnsig_flat[base + n_nu] - lnsig_flat[base])
    rate = m * const * (jnp.exp(lns) / mu) * (2.0 * sp)
    B = planck(nu_val, T)
    return rate * (B - y)


def _rhs_depth(x, y, args):
    """Optical depth: dtau/dx = rate (independent of y)."""
    nu_idx, nu_val, m, lnPg, Tg, mug, lnsig_flat, const, n_nu = args
    sp = jnp.abs(x)
    lnp = 2.0 * jnp.log(sp)
    i, t = _bracket(lnp, lnPg)
    mu = mug[i] + t * (mug[i + 1] - mug[i])
    base = i * n_nu + nu_idx
    lns = lnsig_flat[base] + t * (lnsig_flat[base + n_nu] - lnsig_flat[base])
    rate = m * const * (jnp.exp(lns) / mu) * (2.0 * sp)
    return rate * jnp.ones_like(y)


def _rhs_args(cache: ColumnCache, g: float, nu_idx, nu_val, m_lane):
    const = 1e-4 * N_AVOGADRO / g  # dtau/dP = const*sigma/mu (ref radiation.jl:141)
    dtype = cache.T.dtype
    n_nu = jnp.asarray(cache.nu.shape[0], jnp.int32)
    return (
        nu_idx, nu_val, m_lane, cache.lnP, cache.T, cache.mu,
        cache.ln_sigma.reshape(-1), jnp.asarray(const, dtype), n_nu,
    )


def _eff_tol(tol, dtype):
    """Clamp rtol above float resolution: below ~8 eps the embedded error
    estimate is roundoff-dominated, every step rejects, and lanes burn to
    max_steps (f32 on the GPU with a tolerance tuned on the f64 CPU suite)."""
    return max(float(tol), 8.0 * float(jnp.finfo(dtype).eps))


def _default_atol(tol, B_peak):
    # traced-safe: B_peak may be a tracer inside jit
    return tol * 1e-3 * B_peak


def radau_path_tau(
    cache: ColumnCache,
    P1: float,
    P2: float,
    g: float,
    m: float = 1.0,
    tol: float = 1e-5,
    max_steps: int = 10_000,
):
    """Adaptive slant-path optical depth [n_nu] between two pressures.

    The reference's ``opticaldepth`` Radau path (ref fluxes.jl:39-66,
    core/radau.jl:76-110): one error-controlled integration per wavenumber
    lane, here all lanes at once.
    """
    dtype = cache.T.dtype
    n_nu = cache.nu.shape[0]
    nu_idx = jnp.arange(n_nu, dtype=jnp.int32)
    args = _rhs_args(
        cache, g, nu_idx, cache.nu.astype(dtype), jnp.full((n_nu,), m, dtype)
    )
    tol = _eff_tol(tol, dtype)
    hi, lo = max(P1, P2), min(P1, P2)
    r = radau_scalar(
        _rhs_depth, jnp.zeros((n_nu,), dtype), np.sqrt(lo), np.sqrt(hi),
        args=args, rtol=tol, atol=tol * 1e-6, newton_iters=2,
        max_steps=max_steps,
    )
    return jnp.where(r.ok, r.y, jnp.nan)  # never pass off a truncated integral


def radau_outgoing(
    cache: ColumnCache,
    Ps: float,
    Ptop: float,
    g: float,
    nstream: int = 5,
    tol: float = 1e-5,
    vertical: bool = False,
    max_steps: int = 10_000,
):
    """OLR spectrum [n_nu] by adaptive upward marches (ref radau.jl:133-157,
    fluxes.jl:133-158): surface Planck emission, ``nstream`` hemispheric
    streams, each (stream x wavenumber) lane with its own step control."""
    if vertical:
        m, W = np.array([1.0]), np.array([np.pi])
    else:
        m, W = stream_nodes(nstream)
    dtype = cache.T.dtype
    n_nu = cache.nu.shape[0]
    ns = len(m)
    nu_idx = jnp.tile(jnp.arange(n_nu, dtype=jnp.int32), ns)
    nu_val = jnp.tile(cache.nu.astype(dtype), ns)
    m_lane = jnp.repeat(jnp.asarray(m, dtype), n_nu)
    # surface temperature from the cache's own profile at Ps
    i, t = _bracket(jnp.log(jnp.asarray(Ps, dtype)), cache.lnP)
    Ts = cache.T[i] + t * (cache.T[i + 1] - cache.T[i])
    B_s = planck(cache.nu.astype(dtype), Ts)
    I0 = jnp.tile(B_s, ns)
    args = _rhs_args(cache, g, nu_idx, nu_val, m_lane)
    tol = _eff_tol(tol, dtype)
    atol = _default_atol(tol, jnp.max(B_s))
    r = radau_scalar(
        _rhs_emission, I0, -np.sqrt(Ps), -np.sqrt(Ptop), args=args,
        rtol=tol, atol=atol, newton_iters=2, max_steps=max_steps,
    )
    I_top = jnp.where(r.ok, r.y, jnp.nan).reshape(ns, n_nu)
    return jnp.asarray(W, dtype) @ I_top


def radau_monoflux(
    cache: ColumnCache,
    P,
    g: float,
    S_nu,
    albedo_nu,
    theta_s: float,
    nstream: int = 5,
    tol: float = 1e-5,
    max_steps: int = 10_000,
):
    """Whole-column monochromatic fluxes (M_up, M_down, tau) — M's [np, n_nu],
    tau [np-1, n_nu] per-layer vertical depth (from the adaptive beam leg).

    The reference's ``𝓇monoflux!`` (ref radau.jl:211-271): downward
    atmospheric emission streams, direct stellar beam attenuated by the
    adaptive vertical depth, Lambertian reflection + surface Planck, upward
    streams — each leg an adaptive dense-output integration over the caller's
    levels.
    """
    dtype = cache.T.dtype
    P = jnp.asarray(P, dtype)  # traceable: heating may call this inside jit
    n_lev = P.shape[0]
    n_nu = cache.nu.shape[0]
    m, W = stream_nodes(nstream)
    ns = len(m)
    Wj = jnp.asarray(W, dtype)
    nu_idx = jnp.tile(jnp.arange(n_nu, dtype=jnp.int32), ns)
    nu_val = jnp.tile(cache.nu.astype(dtype), ns)
    m_lane = jnp.repeat(jnp.asarray(m, dtype), n_nu)
    args = _rhs_args(cache, g, nu_idx, nu_val, m_lane)
    tol = _eff_tol(tol, dtype)

    i_lev, t_lev = _bracket(jnp.log(P), cache.lnP)
    Tlev = cache.T[i_lev] + t_lev * (cache.T[i_lev + 1] - cache.T[i_lev])
    B_lev = planck(cache.nu[None, :].astype(dtype), Tlev[:, None])  # [np, n_nu]
    atol = _default_atol(tol, jnp.max(B_lev))

    # downward emission: iota = +sqrt(P), TOA -> surface (ref radau.jl:223-238)
    xs_down = jnp.sqrt(P)
    I_dn = radau_dense(
        _rhs_emission, jnp.zeros((ns * n_nu,), dtype), xs_down,
        args=args, rtol=tol, atol=atol,
        newton_iters=2, max_steps=max_steps,
    ).reshape(n_lev, ns, n_nu)
    M_down = jnp.einsum("k,lkv->lv", Wj, I_dn)

    # direct stellar beam: adaptive vertical depth, attenuated by cos(theta_s)
    # (ref radau.jl:240-247, absorption-only dJ/diota)
    c = jnp.cos(jnp.asarray(theta_s, dtype))
    tau_v = radau_dense(
        _rhs_depth, jnp.zeros((n_nu,), dtype), xs_down,
        args=_rhs_args(
            cache, g,
            jnp.arange(n_nu, dtype=jnp.int32),
            cache.nu.astype(dtype),
            jnp.ones((n_nu,), dtype),
        ),
        rtol=tol, atol=tol * 1e-6, newton_iters=2, max_steps=max_steps,
    )  # [np, n_nu]
    S_nu = jnp.asarray(S_nu, dtype)
    M_down = M_down + (c * S_nu)[None, :] * jnp.exp(-tau_v / c)

    # Lambertian reflection + surface Planck, upward (ref radau.jl:249-266)
    albedo_nu = jnp.asarray(albedo_nu, dtype)
    I_surf = M_down[-1] * albedo_nu / jnp.pi + B_lev[-1]
    xs_up = -xs_down[::-1]  # -sqrt(Ps) -> -sqrt(Ptop)
    I_up = radau_dense(
        _rhs_emission, jnp.tile(I_surf, ns), xs_up, args=args,
        rtol=tol, atol=atol, newton_iters=2, max_steps=max_steps,
    ).reshape(n_lev, ns, n_nu)[::-1]
    M_up = jnp.einsum("k,lkv->lv", Wj, I_up)
    # the surface upward flux of an isotropic boundary is EXACTLY pi*I_surf;
    # the stream quadrature's sum(W) only approximates pi (-0.10 at
    # nstream=2, +2.2e-3 at 3, 1.7e-7 at 5) — pin the boundary like the
    # discretized march and the scipy oracle do, so the engines agree at the
    # level they are cross-checked on
    M_up = M_up.at[-1].set(jnp.pi * I_surf)
    return M_up, M_down, tau_v[1:] - tau_v[:-1]
