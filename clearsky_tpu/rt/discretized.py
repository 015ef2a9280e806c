"""The discretized radiative-transfer core: layered optical depth and flux marches.

Array-first re-design of the reference's primary flux engine (ClearSky.jl
``src/core/discretized.jl``): per-layer optical depth by Gauss-Lobatto
quadrature, the Clough/Iacono/Moncet "linear-in-tau" layer emission, and
up/down flux marches with hemispheric stream quadrature plus a direct stellar
beam and Lambertian surface.

Where the reference threads a scalar ODE per wavenumber, here every march is a
``lax.scan`` over pressure layers carrying the *entire spectrum and all
streams at once* — [nstream, n_nu] per step, pure fused elementwise
arithmetic. All
wavenumber-parallelism is left to XLA/sharding (see ``clearsky_tpu.parallel``).

The reference's adaptive Radau engine (``src/core/radau.jl``) is replaced by a
grid-refinement mode (see ``rt.fluxes.RadauEq``): adaptivity is hostile to the
XLA compilation model, and the linear-in-tau march is already the exact
exponential-integrator solution of the Schwarzschild equation on each layer;
refining the pressure grid recovers the same accuracy (validated against the
analytic gray-atmosphere solution in the test suite).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..constants import N_AVOGADRO
from ..ops.planck import planck
from ..utils.quadrature import stream_nodes, lobatto_unit_nodes
from ..utils.grids import trapz

__all__ = [
    "FluxPack",
    "TAU_MIN",
    "layer_planck",
    "lobatto_pressures",
    "layer_tau",
    "path_tau",
    "monoflux",
    "outgoing_flux",
    "integrate_flux",
]

# The reference floors per-layer optical depth at 1e-6 to protect its
# linear-in-tau emission from 0/0 (ref discretized.jl:147, 174). That floor
# is a physics bias: it adds ~1e-6 of artificial absorber to EVERY layer, and
# the bias grows with grid refinement (measured: the TOA heating error vs the
# adaptive-ODE oracle is ~7x larger with the floor, and doubles when radmul
# doubles). Here layer_planck evaluates the 0/0-prone ratio by series instead
# (exact to f32 roundoff), so no floor is needed; TAU_MIN is kept only as an
# opt-in (`layer_tau(..., floor=True)`) for reference-parity comparisons.
TAU_MIN = 1e-6

# march-scan unroll factor: amortizes loop overhead across layers and lets
# XLA fuse consecutive layers so the [nstream, n_nu] carry round-trips
# device memory less often. Measured on an NVIDIA H100 80GB HBM3 at 700 W,
# 2^19 points x 19 layers x 5 streams (bench.py, median of 7 warm runs):
# monoflux 1.67 / 1.40 / 1.57 / 1.20 ms and outgoing_flux 0.59 / 0.93 /
# 0.62 / 0.65 ms at unroll 1 / 2 / 4 / 8. 8 wins the two-march monoflux
# (the RCM heating path) by 23% over 4 and costs outgoing_flux 0.06 ms.
_UNROLL = 8


def _ratio_series(tm):
    """(1 - e^-tm)/tm = sum_k (-tm)^k/(k+1)!, valid below the 0.25 switch.

    f32 keeps 7 terms (truncation <= 0.25^7/8! ~ 1.5e-9 relative at the
    switch — an order below f32 roundoff); f64 keeps 11 (< 2.4e-14)."""
    if jnp.asarray(tm).dtype == jnp.float32:
        return 1.0 - tm * (0.5 - tm * ((1.0 / 6.0) - tm * (
            (1.0 / 24.0) - tm * ((1.0 / 120.0) - tm * ((1.0 / 720.0)
                                                       - tm * (1.0 / 5040.0))))))
    return 1.0 - tm * (0.5 - tm * ((1.0 / 6.0) - tm * (
        (1.0 / 24.0) - tm * ((1.0 / 120.0) - tm * ((1.0 / 720.0) - tm * (
            (1.0 / 5040.0) - tm * ((1.0 / 40320.0) - tm * (
                (1.0 / 362880.0) - tm * (1.0 / 3628800.0)))))))))


def _trans_emit(tm):
    """(t, omt, ratio): transmittance e^-tm, its complement -expm1(-tm), and
    the linear-in-tau emission ratio omt/tm — all from ONE exp and ONE
    series evaluation (the ratio series is the omt series' inner factor).

    Forming 1 - exp(-tm) directly is the f32 catastrophe for transparent
    layers, hence the series/exp split at tm = 0.25: below it
    omt = tm * ratio_series (exact to f32 roundoff),
    above it 1 - e costs at most one ulp of exp absolute, <= 2.7e-7
    relative at the switch. ratio has no 0/0 hazard this way: the series
    needs no divide, and the large branch divides by tm >= 0.25.
    """
    e = jnp.exp(-tm)
    r = _ratio_series(tm)
    small = tm < 0.25
    omt_l = 1.0 - e
    ratio = jnp.where(small, r, omt_l / jnp.where(small, 1.0, tm))
    omt = jnp.where(small, tm * r, omt_l)
    return 1.0 - omt, omt, ratio


class FluxPack(NamedTuple):
    """Whole-atmosphere radiation bundle. Ref shared.jl:71-121.

    tau:    [np-1, n_nu] per-layer optical depth
    M_up:   [np, n_nu] upward monochromatic flux  [W/m^2/cm^-1]
    M_down: [np, n_nu] downward monochromatic flux
    F_up:   [np] spectrally integrated upward flux [W/m^2]
    F_down: [np] integrated downward flux
    F_net:  [np] F_up - F_down
    """

    tau: jnp.ndarray
    M_up: jnp.ndarray
    M_down: jnp.ndarray
    F_up: jnp.ndarray
    F_down: jnp.ndarray
    F_net: jnp.ndarray


def layer_planck(B1, B2, tau, t, omt=None):
    """Linear-in-tau layer emission (Clough, Iacono & Moncet 1992).

    Ref discretized.jl:83-87: Be = B2(1-t) - (B1-B2)t + (1-t)(B1-B2)/tau,
    the exact solution of the Schwarzschild equation across a layer whose
    Planck function varies linearly in optical depth.

    ``omt`` is 1 - t computed accurately (-expm1(-tau)). Computing it by
    subtraction is catastrophic in float32 for near-transparent layers:
    the ~6% rounding error in (1-t) multiplies dB/tau and biases every
    layer's emission, which accumulates across the column march into O(1)
    flux errors in float32.

    The ratio (1-e^-tau)/tau is 0/0 at tau -> 0; the reference protects it by
    flooring tau at 1e-6 (a physics bias, see TAU_MIN above) — here it is
    evaluated by its Taylor series below tau = 1e-3 (error < 1e-13 at the
    switch point, far under f32 roundoff), so transparent layers are exact.
    """
    dB = B1 - B2
    if omt is None:
        omt = -jnp.expm1(-tau)
    # series: (1 - e^-tau)/tau = 1 - tau/2 + tau^2/6 - tau^3/24 ...
    small = tau < 1e-3
    safe_tau = jnp.where(small, 1.0, tau)
    ratio = jnp.where(
        small, 1.0 - tau * 0.5 + tau * tau * (1.0 / 6.0), omt / safe_tau
    )
    return B2 * omt - dB * t + ratio * dB


def lobatto_pressures(P, nlobatto: int):
    """Intra-layer Gauss-Lobatto node pressures [np-1, nlobatto]. Ref discretized.jl:11-30."""
    x, _ = lobatto_unit_nodes(nlobatto)
    P = jnp.asarray(P)
    dP = P[1:] - P[:-1]
    return P[:-1, None] + dP[:, None] * jnp.asarray(x)[None, :]


def layer_tau(P, Tn, mun, sigman, g, nlobatto: int, floor: bool = False):
    """Per-layer vertical optical depth tau[np-1, n_nu] by Lobatto quadrature.

    Ref discretized.jl:136-177 (``𝒹depth!``) with beta = 1e-4 Na sigma/(g mu)
    (ref discretized.jl:60-81). ``floor=True`` opts into the reference's
    1e-6 tau floor for parity comparisons (see TAU_MIN above); the default is
    floorless — layer_planck handles tau -> 0 exactly.

    Arguments: P [np] ascending; Tn, mun [np-1, nlobatto] at intra-layer nodes;
    sigman [np-1, nlobatto, n_nu] total cross-sections at the nodes.
    """
    _, w = lobatto_unit_nodes(nlobatto)
    w = jnp.asarray(w)
    P = jnp.asarray(P)
    dP = (P[1:] - P[:-1])[:, None, None]
    C = 1e-4 * N_AVOGADRO / g
    beta = C * sigman / mun[:, :, None]
    tau = jnp.sum(dP * w[None, :, None] * beta, axis=1)  # [np-1, n_nu]
    if floor:
        tau = jnp.maximum(tau, jnp.asarray(TAU_MIN, dtype=tau.dtype))
    return tau


def layer_tau_flat(P, muf, sig_flat, g, nlobatto: int, floor: bool = False):
    """Per-layer tau[np-1, n_nu] from FLAT node cross-sections.

    Same quadrature as :func:`layer_tau`, but the node axis stays flat
    ([np-1 * nlobatto, n_nu]) and the whole Lobatto reduction — dP, node
    weight, 1e-4 Na/g, 1/mu — is one static block-diagonal matmul that
    reads sigma exactly once, with sigma evaluated as one flat
    [np-1 * nlobatto, n_nu] batch of states.

    ``muf`` is the flat per-node molar mass [np-1 * nlobatto].
    """
    P = jnp.asarray(P)
    L = P.shape[0] - 1
    k = nlobatto
    _, w = lobatto_unit_nodes(k)
    mask = np.zeros((L, L * k))
    for j in range(k):
        mask[np.arange(L), np.arange(L) * k + j] = w[j]
    dP = P[1:] - P[:-1]
    Wm = jnp.asarray(mask, dtype=sig_flat.dtype) * dP[:, None].astype(sig_flat.dtype)
    Wm = Wm * ((1e-4 * N_AVOGADRO / g) / muf)[None, :].astype(sig_flat.dtype)
    # HIGHEST: a default-precision f32 matmul may run in TF32 on the GPU
    tau = jnp.matmul(Wm, sig_flat, precision=jax.lax.Precision.HIGHEST)
    if floor:
        tau = jnp.maximum(tau, jnp.asarray(TAU_MIN, dtype=tau.dtype))
    return tau


def path_tau(P, Tn, mun, sigman, g, m, nlobatto: int):
    """Total slant-path optical depth [n_nu] between P[0] and P[-1], angle factor m.

    Ref discretized.jl:92-134 (``𝒹depth``) — no per-layer floor is applied on
    this diagnostic path, matching the reference.
    """
    tau = layer_tau(P, Tn, mun, sigman, g, nlobatto, floor=False)
    return m * jnp.sum(tau, axis=0)


def _march(tau, m, B_lo, B_hi, I0, W=None, reverse=False):
    """Scan one direction through layers: I <- I*t + Be.

    tau: [L, n_nu] per-layer VERTICAL optical depth. The stream slant factors
    ``m`` [nstream] are applied INSIDE the scan body — materializing the
    [L, nstream, n_nu] slant depths outside the scan costs ~0.8 GB of
    device-memory round trip per march at production scale (2^19 points, 5 streams), pure
    bandwidth waste the compiler cannot sink into the loop.
    B_lo/B_hi: [L, n_nu] Planck at the entry/exit level of each layer.
    I0: [nstream, n_nu] initial intensity.
    W: optional stream quadrature weights [nstream]. When given, each step
    emits the W-weighted hemispheric flux [n_nu] (5x less stacking traffic
    than emitting the full intensity field); when None, nothing is stacked
    (the caller wants only the final intensity, e.g. ``outgoing_flux``).
    ``reverse=True`` marches from the last layer to the first (the upward
    march) with the per-step emissions still stacked in level order — no
    reversed copies of the inputs are materialized.

    Returns (I_final [nstream, n_nu], emissions [L, n_nu] or None).
    """

    def step(I, xs):
        tau_l, b1, b2 = xs
        tm = tau_l[None, :] * m[:, None]
        # ONE transcendental per stream element. omt is the accuracy-
        # critical quantity — it feeds the 0/0-prone ratio omt/tau in
        # layer_planck (see its docstring) and MUST NOT be formed as
        # 1 - exp(-tm) in f32 for small tm; _trans_emit computes it by a
        # series/exp split that also yields the emission ratio. The
        # transmittance t = 1 - omt is safe this way around: its absolute
        # error is ~1 ulp of 1, and t only ever multiplies the carried
        # intensity, so the march stays at f32 roundoff even for opaque
        # layers where t's RELATIVE error is large.
        t, omt, ratio = _trans_emit(tm)
        dB = b1[None, :] - b2[None, :]
        I = I * t + (b2[None, :] * omt - dB * t + ratio * dB)
        # pinned: a default-precision f32 matmul may run in TF32 on the GPU
        # (~1e-3 relative) — a visible error class on the emitted fluxes
        return I, (None if W is None else jnp.matmul(
            W, I, precision=jax.lax.Precision.HIGHEST))

    return lax.scan(step, I0, (tau, B_lo, B_hi), reverse=reverse, unroll=_UNROLL)


def monoflux(tau, B, nu, S_nu, albedo_nu, theta_s, nstream: int):
    """Whole-column monochromatic up/down fluxes. Ref discretized.jl:249-326.

    Arguments:
      tau: [L, n_nu] per-layer vertical optical depth (L = np-1), floorless
        by design (layer_planck handles tau -> 0 exactly; see TAU_MIN).
      B: [np, n_nu] Planck at levels (P ascending: index 0 = TOA, -1 = surface).
      nu: [n_nu] wavenumbers.
      S_nu: [n_nu] incoming stellar spectral flux at TOA [W/m^2/cm^-1].
      albedo_nu: [n_nu] surface albedo.
      theta_s: stellar zenith angle [rad] (default cos ~ 2/3 upstream).
      nstream: hemispheric quadrature order.

    Returns (M_up, M_down): [np, n_nu].
    """
    ctheta = jnp.cos(jnp.asarray(theta_s, dtype=tau.dtype))
    m, W = stream_nodes(nstream)
    m = jnp.asarray(m, dtype=tau.dtype)
    W = jnp.asarray(W, dtype=tau.dtype)
    L, n_nu = tau.shape

    # downward atmospheric emission (ref :282-294)
    I0 = jnp.zeros((nstream, n_nu), dtype=tau.dtype)
    _, M_down_body = _march(tau, m, B[:-1], B[1:], I0, W=W)  # [L, n_nu]
    M_down = jnp.concatenate([jnp.zeros((1, n_nu), tau.dtype), M_down_body], axis=0)

    # direct stellar beam, attenuated by exp(-tau/cos(theta_s)) (ref :299-304)
    beam_top = ctheta * S_nu
    beam = beam_top[None, :] * jnp.exp(-jnp.cumsum(tau, axis=0) / ctheta)
    M_down = M_down + jnp.concatenate([beam_top[None, :], beam], axis=0)

    # Lambertian reflection + surface Planck emission, marched upward
    # (ref :309-322): a reverse scan from the surface layer, emissions
    # stacked directly in level order
    I_surf = M_down[-1] * albedo_nu / jnp.pi + B[-1]  # [n_nu]
    _, M_up_body = _march(
        tau, m, B[1:], B[:-1],
        jnp.broadcast_to(I_surf[None, :], (nstream, n_nu)),
        W=W, reverse=True,
    )
    M_up = jnp.concatenate([M_up_body, (jnp.pi * I_surf)[None, :]], axis=0)
    return M_up, M_down


def outgoing_flux(tau, B, nstream: int, vertical: bool = False):
    """Outgoing monochromatic flux at TOA [n_nu]: upward march from surface Planck.

    The working semantics of the reference's ``outgoing`` (Radau path,
    ref fluxes.jl:133-158; the discretized variant upstream is dead code — see
    SURVEY.md quirks): surface emission only, no stellar beam, no reflection.

    ``vertical=True`` uses a single vertical beam scaled by pi (flux = pi*I(m=1))
    instead of hemispheric quadrature — the convention of the analytic
    gray-atmosphere solution and the reference's gray test
    (ref test/test_gray.jl:43, ``pi*stream(...)`` with m = 1).
    """
    if vertical:
        m, W = np.array([1.0]), np.array([np.pi])
        nstream = 1
    else:
        m, W = stream_nodes(nstream)
    # take the stream count from the HOST arrays before the device cast:
    # inside a jit trace the dtype cast stages an op (m becomes a tracer)
    # and np.asarray(m) would raise TracerArrayConversionError
    nstream, n_nu = len(m), tau.shape[1]
    m = jnp.asarray(m, dtype=tau.dtype)
    W = jnp.asarray(W, dtype=tau.dtype)
    I_surf = jnp.broadcast_to(B[-1][None, :], (nstream, n_nu))
    # reverse scan from the surface layer; only the TOA intensity is kept,
    # so nothing is stacked (W=None) — the round-3 version stacked the full
    # [L, nstream, n_nu] intensity history (~0.4 GB at 2^19) to read one row
    I_toa, _ = _march(tau, m, B[1:], B[:-1], I_surf, reverse=True)
    return jnp.einsum("k,kv->v", W, I_toa,
                      precision=jax.lax.Precision.HIGHEST)


def integrate_flux(M_up, M_down, nu):
    """Spectral integration of monochromatic fluxes (row-wise trapz). Ref shared.jl:125-136."""
    F_up = trapz(nu, M_up, axis=-1)
    F_down = trapz(nu, M_down, axis=-1)
    return F_up, F_down
