"""GPU line-sum kernel: Pallas through Triton.

The plain path (:func:`ops.linesum.sigma_from_lines`) pads every wavenumber
block to the widest line window of any block and evaluates the whole
[block x slab] tile under a mask. On line catalogs whose per-block line
counts are strongly skewed (most blocks see a handful of lines, a few see
hundreds) most of that work is masked out, and XLA cannot express a
per-block trip count. This kernel can:

* the grid runs over (wavenumber blocks x states); each program owns one
  block of ``plan.block`` grid points for one (T, P) state;
* each program reads its own ``start``/``count`` from the plan and walks
  only its own window, ``CHUNK`` lines at a time, with masked loads;
* line positions are differenced in two-float form (f32 hi + f32 residual,
  see ``SpectralLines.nu_lo``), the profile is evaluated in registers
  (``ops.faddeeva`` is branch-free real arithmetic), the sum accumulates in
  f32 and the block is stored once.

Per-(state, line) S, alpha and gamma are computed by XLA
(``ops.linesum._line_params``) and read by the kernel. The kernel is
float32 only; :func:`sigma_from_lines_gpu` carries a custom JVP whose
tangent goes through the plain path, so ``jax.jacfwd`` works through it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .faddeeva import wofz_re_kernel
from .lineshape import chi_phco2, fdoppler, florentz
from .linesum import (
    DeviceWindowPlan,
    _flatten_states,
    _line_params,
    sigma_from_lines,
    sigma_from_lines_device,
    split_f64,
)

__all__ = [
    "CHUNK",
    "NUM_WARPS",
    "SHAPES",
    "sigma_from_lines_gpu",
    "sigma_from_lines_gpu_device",
    "linesum_kernel",
]

# lines per inner step of a program's window walk, and warps per program:
# the [block x CHUNK] profile tile is spread over NUM_WARPS * 32 threads.
# Measured on an H100 (16 states x 2^19 points, synthetic CO2): at 16
# elements per thread or more the Faddeeva temporaries spill and the kernel
# runs ~50x slower; 4 per thread (CHUNK 4, 4 warps) is the fastest tried,
# 11% (voigt) and 20% (phco2) ahead of 8 per thread
CHUNK = 4
NUM_WARPS = 4

SHAPES = ("voigt", "voigt_ref", "lorentz", "doppler", "phco2", "phco2_ref")

_SQRT_PI = 1.7724538509055159
_SQRT_LN2 = 0.8325546111576977


def _profile(shape, dnu, S, a, g, T):
    """``ops.linesum.PROFILES`` without custom-JVP wrappers (kernel bodies
    are never differentiated)."""
    if shape in ("voigt_ref", "phco2_ref"):
        a = a * (1.0 / _SQRT_LN2)
    if shape == "lorentz":
        return S * florentz(dnu, g)
    if shape == "doppler":
        return S * fdoppler(dnu, a)
    if shape.startswith("phco2"):
        g = g * chi_phco2(dnu, T)
    beta = 1.0 / a
    return S * (beta * (1.0 / _SQRT_PI)) * wofz_re_kernel(dnu * beta, g * beta)


def _kernel(start_ref, count_ref, nb_hi_ref, nb_lo_ref, nl_hi_ref, nl_lo_ref,
            S_ref, A_ref, G_ref, T_ref, out_ref, *, shape, cut, chunk):
    s0 = start_ref[0]
    cnt = count_ref[0]
    nb_hi = nb_hi_ref[...][:, None]            # [B, 1]
    nb_lo = nb_lo_ref[...][:, None]
    T = T_ref[0]
    lane = jnp.arange(chunk, dtype=jnp.int32)

    def body(c, acc):
        off = s0 + c * chunk
        valid = c * chunk + lane < cnt         # [C]
        sl = pl.ds(off, chunk)
        nl_hi = plgpu.load(nl_hi_ref.at[sl], mask=valid, other=0.0)
        nl_lo = plgpu.load(nl_lo_ref.at[sl], mask=valid, other=0.0)
        S = plgpu.load(S_ref.at[sl], mask=valid, other=0.0)
        a = plgpu.load(A_ref.at[sl], mask=valid, other=1.0)
        g = plgpu.load(G_ref.at[sl], mask=valid, other=1.0)
        # two-float difference: the hi part is exact for nearby values
        # (Sterbenz), the residuals restore sub-f32 position information
        dnu = (nb_hi - nl_hi[None, :]) + (nb_lo - nl_lo[None, :])   # [B, C]
        f = _profile(shape, dnu, S[None, :], a[None, :], g[None, :], T)
        keep = valid[None, :] & (jnp.abs(dnu) <= cut)
        return acc + jnp.sum(jnp.where(keep, f, 0.0), axis=1)

    n_chunks = (cnt + (chunk - 1)) // chunk
    acc = jax.lax.fori_loop(0, n_chunks, body,
                            jnp.zeros(nb_hi.shape[:1], jnp.float32))
    out_ref[...] = acc


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def linesum_kernel(nb_hi, nb_lo, start, count, nl_hi, nl_lo, S, A, G, T, *,
                   shape: str, cut: float, interpret: bool = False):
    """Raw kernel call: sigma [n_states, n_blocks * B] (float32).

    nb_hi/nb_lo: [n_blocks, B] two-float block grid (B a power of two);
    start/count: [n_blocks] int32 line windows; nl_hi/nl_lo: [n_lines]
    two-float line positions; S/A/G: [n_states, n_lines] per-(state, line)
    intensity and widths; T: [n_states] temperatures.
    """
    if shape not in SHAPES:
        raise ValueError(f"unknown line shape {shape!r}; expected one of {SHAPES}")
    n_blocks, B = nb_hi.shape
    if B != _pow2(B):
        raise ValueError(f"block width {B} must be a power of two")
    n_states, n_lines = S.shape
    chunk = CHUNK
    # pad the line axis by one chunk: every window load then stays inside
    # the array, masked lanes included
    f32 = jnp.float32
    pad1 = lambda x, v: jnp.pad(x.astype(f32), (0, chunk), constant_values=v)
    pad2 = lambda x, v: jnp.pad(x.astype(f32), ((0, 0), (0, chunk)),
                                constant_values=v)
    nl_hi, nl_lo = pad1(nl_hi, 0.0), pad1(nl_lo, 0.0)
    S, A, G = pad2(S, 0.0), pad2(A, 1.0), pad2(G, 1.0)
    L = n_lines + chunk
    row = lambda b, s: (b, 0)
    line = pl.BlockSpec((L,), lambda b, s: (0,))
    state_line = pl.BlockSpec((None, L), lambda b, s: (s, 0))
    out = pl.pallas_call(
        partial(_kernel, shape=shape, cut=float(cut), chunk=chunk),
        out_shape=jax.ShapeDtypeStruct((n_states, n_blocks, B), f32),
        grid=(n_blocks, n_states),
        in_specs=[
            pl.BlockSpec((1,), lambda b, s: (b,)),
            pl.BlockSpec((1,), lambda b, s: (b,)),
            pl.BlockSpec((None, B), row),
            pl.BlockSpec((None, B), row),
            line, line,
            state_line, state_line, state_line,
            pl.BlockSpec((1,), lambda b, s: (s,)),
        ],
        out_specs=pl.BlockSpec((None, None, B), lambda b, s: (s, b, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=f"linesum_{shape}",
    )(
        start.astype(jnp.int32), count.astype(jnp.int32),
        nb_hi.astype(f32), nb_lo.astype(f32), nl_hi, nl_lo, S, A, G,
        T.astype(f32),
    )
    return out.reshape(n_states, n_blocks * B)


def _two_float(x, lo):
    """(hi, lo) float32 positions: split a float64 array, or pair a float32
    one with its stored residual ``lo``."""
    hi = x.astype(jnp.float32)
    if x.dtype == jnp.float64:
        return hi, (x - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, jnp.asarray(lo, jnp.float32)


def _pad_blocks(nb_hi, nb_lo):
    """Widen blocks to a power of two (extra points repeat the block's last
    one and are sliced away after the kernel)."""
    B = nb_hi.shape[-1]
    Bp = _pow2(B)
    if Bp == B:
        return nb_hi, nb_lo
    w = ((0, 0), (0, Bp - B))
    return jnp.pad(nb_hi, w, mode="edge"), jnp.pad(nb_lo, w, mode="edge")


def _run(nb_hi, nb_lo, start, count, block, n_nu, cut, lines, T, P, Pp,
         shape, conc, interpret):
    shp, Tf, Pf, Ppf, concf = _flatten_states(T, P, Pp, conc, lines.nu.shape[0])
    S, A, G = _line_params(lines, Tf, Pf, Ppf, conc=concf)
    n = Tf.shape[0]
    S, A, G = (jnp.broadcast_to(x, (n, lines.nu.shape[0])) for x in (S, A, G))
    nl_hi, nl_lo = _two_float(jnp.asarray(lines.nu), lines.nu_lo)
    nb_hi, nb_lo = _pad_blocks(nb_hi, nb_lo)
    n_blocks, Bp = nb_hi.shape
    sig = linesum_kernel(nb_hi, nb_lo, start, count, nl_hi, nl_lo, S, A, G,
                         Tf, shape=shape, cut=cut, interpret=interpret)
    if Bp != block:
        sig = sig.reshape(n, n_blocks, Bp)[:, :, :block].reshape(n, -1)
    return sig[:, :n_nu].reshape(shp + (n_nu,))


@partial(jax.custom_jvp, nondiff_argnums=(0, 1, 2))
def _static_core(plan, shape, interpret, lines, T, P, Pp, conc):
    nb_hi, nb_lo = map(jnp.asarray, split_f64(plan.nu_blocks))
    return _run(nb_hi, nb_lo, jnp.asarray(plan.start), jnp.asarray(plan.count),
                plan.block, plan.n_nu, plan.cut, lines, T, P, Pp, shape, conc,
                interpret)


@_static_core.defjvp
def _static_jvp(plan, shape, interpret, primals, tangents):
    out = _static_core(plan, shape, interpret, *primals)
    _, dout = jax.jvp(
        lambda lines, T, P, Pp, conc: sigma_from_lines(
            plan, lines, T, P, Pp, shape, conc=conc),
        primals, tangents,
    )
    return out, dout.astype(out.dtype)


def sigma_from_lines_gpu(plan, lines, T, P, Pp, shape: str = "voigt",
                         conc=None, interpret: bool = False):
    """Kernel line sum over a static :class:`LineWindowPlan`.

    Same contract as :func:`ops.linesum.sigma_from_lines` (any broadcastable
    state batch, optional per-line concentrations), float32 result.
    """
    return _static_core(plan, shape, interpret, lines, T, P, Pp, conc)


@partial(jax.custom_jvp, nondiff_argnums=(0, 1))
def _device_core(shape, interpret, dplan, lines, T, P, Pp, conc):
    nb_hi, nb_lo = _two_float(dplan.nu_blocks, dplan.nu_blocks_lo)
    return _run(nb_hi, nb_lo, dplan.start, dplan.count, dplan.block,
                dplan.n_nu, dplan.cut, lines, T, P, Pp, shape, conc, interpret)


@_device_core.defjvp
def _device_jvp(shape, interpret, primals, tangents):
    out = _device_core(shape, interpret, *primals)
    _, dout = jax.jvp(
        lambda dplan, lines, T, P, Pp, conc: sigma_from_lines_device(
            dplan, lines, T, P, Pp, shape, conc=conc),
        primals, tangents,
    )
    return out, dout.astype(out.dtype)


def sigma_from_lines_gpu_device(dplan: DeviceWindowPlan, lines, T, P, Pp,
                                shape: str = "voigt", conc=None,
                                interpret: bool = False):
    """Kernel line sum over a :class:`DeviceWindowPlan` (the nu-sharded
    path: the plan may be traced or sharded, e.g. inside ``shard_map``)."""
    return _device_core(shape, interpret, dplan, lines, T, P, Pp, conc)
