"""Block-banded line-sum: dense accumulation of line profiles onto a wavenumber grid.

This is the hot kernel of the whole framework — the array-first inversion of
the reference's moving-window scalar sweep (``surf!``, ClearSky.jl
``line_shapes.jl:53-87``, and its truncation helpers ``cutline``/``includedlines``
at ``line_shapes.jl:10-22``).

Design: lines are sorted by wavenumber (a static invariant of SpectralLines),
so the set of lines within ``cut`` of a *contiguous block* of the wavenumber
grid is a contiguous slab of line indices. The slab boundaries are computed
host-side once per (grid, catalog) pair with ``numpy.searchsorted`` and baked
into a static :class:`LineWindowPlan`. The plain path here processes
[block x slab] tiles with pure dense arithmetic — no gathers of ragged
structure, no data-dependent control flow. Out-of-window and cut-truncated
elements are masked with ``jnp.where``.

The GPU kernel in ``linesum_gpu.py`` walks each block's own window instead
of the padded slab; this module is the portable path, the kernel's tangent
rule and its correctness reference. :func:`sigma_from_lines_auto` picks
between them (see ``clearsky_tpu.backend``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..backend import linesum_impl
from .lineshape import (
    scale_intensity,
    cheb_qref_q,
    alpha_doppler,
    gamma_lorentz,
    fdoppler,
    florentz,
    fvoigt,
    chi_phco2,
)

__all__ = [
    "LineWindowPlan",
    "DeviceWindowPlan",
    "build_line_window_plan",
    "sigma_from_lines",
    "sigma_from_lines_device",
    "sigma_from_lines_auto",
    "sigma_from_lines_auto_device",
    "PROFILES",
]

_SQRT_LN2 = 0.8325546111576977  # sqrt(ln 2)

# unified profile signature: f(dnu, S, alpha, gamma, T) -> cross-section [cm^2/molecule]
# The *_ref variants reproduce the reference's HWHM-convention Voigt formula
# (ref line_shapes.jl:366-378) exactly: it multiplies x, y and the prefactor by
# sqrt(ln2) while feeding the 1/e Doppler width, which is algebraically
# identical to the internal convention with alpha -> alpha/sqrt(ln2). See
# ops.lineshape.fvoigt for why the internal convention is the default.
PROFILES = {
    "voigt": lambda dnu, S, a, g, T: S * fvoigt(dnu, a, g),
    "lorentz": lambda dnu, S, a, g, T: S * florentz(dnu, g),
    "doppler": lambda dnu, S, a, g, T: S * fdoppler(dnu, a),
    "phco2": lambda dnu, S, a, g, T: S * fvoigt(dnu, a, chi_phco2(dnu, T) * g),
    "voigt_ref": lambda dnu, S, a, g, T: S * fvoigt(dnu, a / _SQRT_LN2, g),
    "phco2_ref": lambda dnu, S, a, g, T: S
    * fvoigt(dnu, a / _SQRT_LN2, chi_phco2(dnu, T) * g),
}

# lines summed per fused step of the plain path (see _sigma_blocks)
SLAB_CHUNK = 1024

DEFAULT_CUT = {
    "voigt": 25.0,
    "lorentz": 25.0,
    "doppler": 25.0,
    "phco2": 500.0,
    "voigt_ref": 25.0,
    "phco2_ref": 500.0,
}


def split_f64(x) -> tuple[np.ndarray, np.ndarray]:
    """Two-float form of a float64 host array: (f32 hi, f32 residual), with
    hi + lo reproducing x to ~1e-7 relative of hi's rounding."""
    x64 = np.asarray(x, np.float64)
    hi = x64.astype(np.float32)
    return hi, (x64 - hi.astype(np.float64)).astype(np.float32)


@dataclasses.dataclass(frozen=True, eq=False)
class LineWindowPlan:
    """Static banding plan mapping wavenumber blocks to line-index slabs.

    Hash/eq are by identity: plans are built once per (grid, catalog) pair and
    reused, so identity hashing gives stable jit caching.
    """

    nu: np.ndarray          # [n_nu] sorted wavenumber grid
    cut: float              # profile truncation distance [cm^-1]
    block: int              # wavenumber block size
    n_blocks: int
    nu_blocks: np.ndarray   # [n_blocks, block] padded grid
    start: np.ndarray       # [n_blocks] first line index per block
    count: np.ndarray       # [n_blocks] number of in-window lines per block
    slab: int               # padded slab length (max over blocks)

    @property
    def n_nu(self) -> int:
        return len(self.nu)


def build_line_window_plan(
    nu_grid: np.ndarray,
    nu_lines: np.ndarray,
    cut: float,
    block: int = 128,
) -> LineWindowPlan:
    """Construct the static block->line-slab banding (host-side, setup time).

    Equivalent information to the reference's runtime moving window
    (ref line_shapes.jl:61-75), precomputed so the device kernel is dense.
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu_lines = np.asarray(nu_lines, dtype=np.float64)
    if np.any(np.diff(nu_grid) <= 0):
        raise ValueError("wavenumber grid must be strictly ascending")
    if len(nu_lines) > 1 and np.any(np.diff(nu_lines) < 0):
        raise ValueError("line wavenumbers must be sorted ascending")
    n = len(nu_grid)
    block = int(min(block, max(8, n)))
    n_blocks = -(-n // block)
    npad = n_blocks * block
    # pad with the last grid value; padded outputs are sliced away
    pad = np.full(npad - n, nu_grid[-1])
    nu_blocks = np.concatenate([nu_grid, pad]).reshape(n_blocks, block)
    lo = np.searchsorted(nu_lines, nu_blocks[:, 0] - cut, side="left")
    hi = np.searchsorted(nu_lines, nu_blocks[:, -1] + cut, side="right")
    count = (hi - lo).astype(np.int32)
    slab = int(max(1, count.max() if len(count) else 1))
    # round slab up to a lane-friendly multiple
    slab = -(-slab // 128) * 128 if slab > 128 else slab
    return LineWindowPlan(
        nu=nu_grid,
        cut=float(cut),
        block=block,
        n_blocks=n_blocks,
        nu_blocks=nu_blocks,
        start=lo.astype(np.int32),
        count=count,
        slab=slab,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class DeviceWindowPlan:
    """Banding plan with per-block data as *device arrays* (pytree leaves).

    Same information as :class:`LineWindowPlan`, but ``nu_blocks``/``start``/
    ``count`` are jax arrays, so the plan can be sharded over a device mesh and
    traced inside ``shard_map``/``jit`` — the representation the nu-sharded
    line-by-line opacity path uses (each spectral shard carries its own plan
    against its own line slab; SURVEY.md §5 "long-context" halo design).

    ``nu_blocks`` keeps the grid at the ambient precision (float64 on the CPU
    suite); ``nu_blocks_lo`` holds the float32 residual of the float64 grid so
    float32 device kernels reconstruct block positions via two-float
    arithmetic (see ``linesum_gpu``).
    """

    nu_blocks: jax.Array     # [n_blocks, block]
    nu_blocks_lo: jax.Array  # [n_blocks, block] float32 residual
    start: jax.Array         # [n_blocks] int32
    count: jax.Array         # [n_blocks] int32
    cut: float = dataclasses.field(metadata=dict(static=True), default=25.0)
    block: int = dataclasses.field(metadata=dict(static=True), default=256)
    n_blocks: int = dataclasses.field(metadata=dict(static=True), default=1)
    slab: int = dataclasses.field(metadata=dict(static=True), default=1)
    n_nu: int = dataclasses.field(metadata=dict(static=True), default=1)

    @classmethod
    def from_plan(cls, plan: LineWindowPlan) -> "DeviceWindowPlan":
        return cls(
            nu_blocks=jnp.asarray(np.asarray(plan.nu_blocks, np.float64)),
            nu_blocks_lo=jnp.asarray(split_f64(plan.nu_blocks)[1]),
            start=jnp.asarray(plan.start, jnp.int32),
            count=jnp.asarray(plan.count, jnp.int32),
            cut=float(plan.cut),
            block=int(plan.block),
            n_blocks=int(plan.n_blocks),
            slab=int(plan.slab),
            n_nu=int(plan.n_nu),
        )


def _line_params(lines, T, P, Pp, conc=None):
    """Per-line profile parameters at temperature/pressure, batched over T/P dims.

    T, P, Pp: broadcastable arrays of shape [...]. Returns (S, alpha, gamma)
    each of shape [..., n_lines]. Mirrors the reference's per-window param
    evaluation (ref line_shapes.jl:419-422) but for all lines densely.

    ``conc`` optionally gives PER-LINE molar concentrations — shape [n_lines]
    (fixed, merged multi-molecule catalogs, see ``spectra.merge``) or
    [..., n_lines] (temperature/pressure-dependent per-molecule fC evaluated
    per state): partial pressures become conc*P per line and intensities are
    concentration-scaled, so one kernel pass evaluates the whole gas mixture.
    """
    T = jnp.asarray(T)[..., None]
    P = jnp.asarray(P)[..., None]
    if conc is not None:
        Pp = jnp.asarray(conc) * P
    else:
        Pp = jnp.asarray(Pp)[..., None]
    coeffs = lines.tips_coeffs[lines.iso_ptr]  # [n_lines, ncheb]
    qq = cheb_qref_q(T, coeffs)
    S = scale_intensity(lines.S, lines.nu, lines.Epp, qq, T)
    if conc is not None:
        S = S * jnp.asarray(conc)
    alpha = alpha_doppler(lines.nu, lines.mu, T)
    gamma = gamma_lorentz(lines.ga, lines.gs, lines.na, T, P, Pp)
    return S, alpha, gamma


@partial(jax.jit, static_argnames=("plan", "shape", "batch_blocks"))
def sigma_from_lines(
    plan: LineWindowPlan,
    lines,
    T,
    P,
    Pp,
    shape: str = "voigt",
    batch_blocks: int = 4,
    conc=None,
):
    """Absorption cross-section sigma[..., n_nu] [cm^2/molecule] from line data.

    The array-push equivalent of the reference's ``voigt!``/``lorentz!``/
    ``doppler!``/``PHCO2!`` (ref line_shapes.jl:412-424,313-324,200-211,527-540):
    one call fills the full wavenumber grid for a batch of (T, P) states.

    Arguments:
      plan: static banding plan for (grid, catalog).
      lines: SpectralLines pytree (see ``clearsky_tpu.spectra.lines``).
      T, P, Pp: temperature [K], pressure [Pa], partial pressure [Pa];
        broadcastable leading batch shape [...].
      shape: one of 'voigt' | 'lorentz' | 'doppler' | 'phco2'.
    """
    T = jnp.asarray(T)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc=conc)
    if S.dtype == jnp.float32:
        # float32 environment (x64 disabled, as on the GPU): carry the
        # two-float position residuals so the plain path's dnu matches
        # float64 to ~1e-7 cm^-1 — this path is also the tangent rule of
        # the GPU kernel's custom JVP, so Jacobians near line cores need it
        # as much as the kernel's own primal does (see linesum_gpu)
        nu_blocks, nu_blocks_lo = map(jnp.asarray, split_f64(plan.nu_blocks))
        nu_l_lo = jnp.asarray(lines.nu_lo, jnp.float32)
    else:
        nu_blocks = jnp.asarray(plan.nu_blocks, dtype=S.dtype)
        nu_blocks_lo = None
        nu_l_lo = None
    return _sigma_blocks(
        shape, T, S, alpha, gamma, lines.nu, nu_l_lo,
        nu_blocks, nu_blocks_lo,
        jnp.asarray(plan.start), jnp.asarray(plan.count),
        plan.cut, plan.slab, plan.n_blocks, plan.block, plan.n_nu, batch_blocks,
    )


def _sigma_blocks(shape, T, S, alpha, gamma, nu_l, nu_l_lo, nu_blocks,
                  nu_blocks_lo, starts, counts,
                  cut, slab, n_blocks, block, n_nu, batch_blocks):
    """Shared block-banded contraction over (nu_blocks, starts, counts).

    ``nu_l_lo``/``nu_blocks_lo`` are the float32 position residuals (two-float
    dnu, as in the GPU kernel) — pass None in float64 environments, where a
    single subtraction is already exact to ~1e-10 cm^-1.

    Slabs wider than ``SLAB_CHUNK`` lines are summed ``SLAB_CHUNK`` lines
    at a time (a loop inside each block): one fused [block x slab] tile of
    a wide cut (phco2 at 500 cm^-1: ~3700 lines) takes XLA's GPU compiler
    minutes to compile.
    """
    profile = PROFILES[shape]
    n_lines = nu_l.shape[0]
    chunk = min(slab, SLAB_CHUNK)
    n_chunks = -(-slab // chunk)
    offs = jnp.arange(chunk, dtype=jnp.int32)
    two_float = nu_l_lo is not None
    if not two_float:
        nu_blocks_lo = jnp.zeros_like(nu_blocks)  # unused lax.map operand slot

    def block_fn(xs):
        nu_b, nu_b_lo, s0, cnt = xs  # [B], [B], scalar, scalar

        def part(o):
            idx = jnp.clip(s0 + o + offs, 0, max(n_lines - 1, 0))
            valid = o + offs < cnt
            nul_b = nu_l[idx]                      # [chunk]
            S_b = S[..., idx][..., None, :]        # [..., 1, chunk]
            a_b = alpha[..., idx][..., None, :]
            g_b = gamma[..., idx][..., None, :]
            dnu = nu_b[:, None] - nul_b[None, :]   # [B, chunk]
            if two_float:
                # hi difference is exact for nearby values (Sterbenz);
                # residuals restore the sub-f32 position information
                dnu = dnu + (nu_b_lo[:, None] - nu_l_lo[idx][None, :])
            mask = valid[None, :] & (jnp.abs(dnu) <= cut)
            Tb = T[..., None, None] if T.ndim else T
            f = profile(dnu, S_b, a_b, g_b, Tb)    # [..., B, chunk]
            return jnp.sum(jnp.where(mask, f, 0.0), axis=-1)

        acc = part(0)
        if n_chunks > 1:
            acc = lax.fori_loop(1, n_chunks,
                                lambda c, acc: acc + part(c * chunk), acc)
        return acc

    sig = lax.map(
        block_fn,
        (nu_blocks, nu_blocks_lo, starts, counts),
        batch_size=min(batch_blocks, n_blocks),
    )  # [n_blocks, ..., B]
    sig = jnp.moveaxis(sig, 0, -2)  # [..., n_blocks, B]
    sig = sig.reshape(sig.shape[:-2] + (n_blocks * block,))
    return sig[..., :n_nu]


@partial(jax.jit, static_argnames=("shape", "batch_blocks"))
def sigma_from_lines_device(
    dplan: DeviceWindowPlan,
    lines,
    T,
    P,
    Pp,
    shape: str = "voigt",
    batch_blocks: int = 4,
    conc=None,
):
    """:func:`sigma_from_lines` with the banding plan as device arrays.

    Identical contraction; ``dplan`` is a pytree, so this form works with the
    plan (and line slab) sharded over a mesh and traced inside ``shard_map`` —
    the nu-sharded path of SURVEY.md §2.3/§5. At float32 the full-precision
    block grid is reconstructed as hi + lo before differencing.
    """
    T = jnp.asarray(T)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc=conc)
    if S.dtype == jnp.float32:
        # float32 environment: two-float dnu from the plan's hi/lo block
        # positions and the catalog's nu_lo residuals (see _sigma_blocks)
        nu_blocks = dplan.nu_blocks.astype(jnp.float32)
        nu_blocks_lo = dplan.nu_blocks_lo
        nu_l_lo = jnp.asarray(lines.nu_lo, jnp.float32)
    else:
        nu_blocks = dplan.nu_blocks.astype(S.dtype)
        nu_blocks_lo = None
        nu_l_lo = None
    return _sigma_blocks(
        shape, T, S, alpha, gamma, lines.nu, nu_l_lo,
        nu_blocks, nu_blocks_lo, dplan.start, dplan.count,
        dplan.cut, dplan.slab, dplan.n_blocks, dplan.block, dplan.n_nu,
        batch_blocks,
    )


def _flatten_states(T, P, Pp, conc, n_lines):
    """Broadcast (T, P, Pp[, conc]) to a flat 1-D state batch."""
    T = jnp.asarray(T)
    P = jnp.asarray(P)
    Pp = P if Pp is None else jnp.asarray(Pp)  # conc-mode callers pass None
    shp = jnp.broadcast_shapes(T.shape, P.shape, Pp.shape)
    concf = None
    if conc is not None:
        conc = jnp.asarray(conc)
        if conc.ndim > 1:  # state-dependent per-line concentrations
            shp = jnp.broadcast_shapes(shp, conc.shape[:-1])
            concf = jnp.broadcast_to(conc, shp + (n_lines,)).reshape(-1, n_lines)
        else:
            concf = conc
    Tf = jnp.broadcast_to(T, shp).reshape(-1)
    Pf = jnp.broadcast_to(P, shp).reshape(-1)
    Ppf = jnp.broadcast_to(Pp, shp).reshape(-1)
    return shp, Tf, Pf, Ppf, concf


def sigma_from_lines_auto(plan, lines, T, P, Pp, shape: str = "voigt",
                          conc=None):
    """Line sum on the implementation ``clearsky_tpu.backend`` selects: the
    GPU kernel (``linesum_gpu``) on the GPU, the plain path on the CPU.

    Accepts any broadcastable batch shape for (T, P, Pp). Differentiable:
    the kernel carries a custom JVP whose tangent goes through the plain
    path.
    """
    if linesum_impl(lines.S.dtype) == "xla":
        return sigma_from_lines(plan, lines, T, P, Pp, shape, conc=conc)
    from .linesum_gpu import sigma_from_lines_gpu

    return sigma_from_lines_gpu(plan, lines, T, P, Pp, shape, conc=conc)


def sigma_from_lines_auto_device(dplan, lines, T, P, Pp, shape="voigt",
                                 conc=None):
    """:func:`sigma_from_lines_auto` over a device-array plan (sharded path)."""
    if linesum_impl(lines.S.dtype) == "xla":
        return sigma_from_lines_device(dplan, lines, T, P, Pp, shape, conc=conc)
    from .linesum_gpu import sigma_from_lines_gpu_device

    return sigma_from_lines_gpu_device(dplan, lines, T, P, Pp, shape, conc=conc)
