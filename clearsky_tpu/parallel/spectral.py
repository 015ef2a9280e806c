"""Sharded spectral computation: flux solves and RCE steps over a device mesh.

Two complementary paths, both producing bit-identical physics to the
single-device API:

* **GSPMD** (:func:`sharded_radiate`, the default): place the absorber and
  spectral boundary arrays on the mesh with :func:`~.mesh.shard_spectral` and
  jit the ordinary flux code — XLA propagates the 'nu' sharding through every
  per-wavenumber op and inserts exactly one all-reduce for the spectral
  integral. Zero code duplication, and the compiler overlaps the reduction
  with surrounding work.

* **shard_map** (:func:`make_sharded_heating`, :func:`make_sharded_step`):
  explicit per-shard programs with a hand-placed ``lax.psum`` — the form that
  guarantees the collective schedule for the RCE inner loop, where one psum
  per step is the entire communication budget (SURVEY.md §2.3).

The wavenumber grid is sharded in **contiguous blocks** so each shard's line
set is a compact slab (SURVEY.md §5 "long-context" notes); with trapz folded
into static pointwise weights there is no halo exchange at all.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import inspect as _inspect

try:
    from jax import shard_map as _shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map

# the replication-check kwarg was renamed check_rep -> check_vma in jax 0.8
_CHECK_KW = (
    "check_vma"
    if "check_vma" in _inspect.signature(_shard_map).parameters
    else "check_rep"
)


def shard_map(f, *, mesh, in_specs, out_specs):
    return _shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **{_CHECK_KW: False}
    )

from ..models import rcm as rcm_mod
from ..rt.discretized import FluxPack
from .mesh import trapz_weights, shard_spectral, spectral_pspecs, nu_spec

__all__ = [
    "pad_nu",
    "shard_lbl",
    "sharded_radiate",
    "make_sharded_heating",
    "make_sharded_step",
]


def pad_nu(n_nu: int, n_shards: int) -> int:
    """Padded spectral length divisible by the shard count (pad wavenumbers are
    appended by the caller with zero trapz weight, so they change nothing)."""
    return -(-n_nu // n_shards) * n_shards


def shard_lbl(tree, n_shards: int):
    """Convert every DirectGas/MultiGas in a model pytree to a ShardedLineGas.

    Line-by-line gases hold a *global* banding plan against the full catalog;
    evaluated inside a spectral shard they would sum the whole spectrum's
    lines against a local grid slice. This rewrites them to per-shard line
    slabs + plans (see ``absorption.sharded``) so the sharded flux/heating
    programs are correct for the flagship line-by-line path — the parity
    anchor for the reference's threads-over-nu with real gases
    (ref fluxes.jl:270). Applied automatically by the sharded program
    builders below.
    """
    from ..absorption.gas import DirectGas, MultiGas
    from ..absorption.sharded import shard_line_gas

    is_lbl = lambda x: isinstance(x, (DirectGas, MultiGas))
    return jax.tree.map(
        lambda x: shard_line_gas(x, n_shards) if is_lbl(x) else x,
        tree,
        is_leaf=is_lbl,
    )


def sharded_radiate(mesh: Mesh, rcm) -> FluxPack:
    """Radiate the RCM state with the spectrum sharded over ``mesh`` (GSPMD).

    Places every [..., n_nu] leaf of the model on the 'nu' mesh axis and jits
    the standard flux solve; XLA auto-inserts the all-reduce for the spectral
    integral. Requires n_nu divisible by the 'nu' mesh size.
    """
    n_nu = rcm.nu.shape[0]
    _check_divisible(n_nu, mesh)
    rcm_s = shard_spectral(shard_lbl(rcm, mesh.shape["nu"]), mesh, n_nu)
    return jax.jit(rcm_mod.radiate_state)(rcm_s)


def _check_divisible(n_nu: int, mesh: Mesh):
    k = mesh.shape["nu"]
    if n_nu % k != 0:
        raise ValueError(
            f"n_nu={n_nu} not divisible by nu-mesh size {k}; pad the wavenumber "
            f"grid to {pad_nu(n_nu, k)} (use pad_nu; give pad points zero weight)"
        )


def make_sharded_heating(mesh: Mesh, rcm):
    """Explicit shard_map heating program: ``f(T, A) -> H``.

    Each shard computes its local monochromatic fluxes for the whole column;
    the only collective is one ``lax.psum`` of the weighted spectral sums.
    """
    n_nu = rcm.nu.shape[0]
    _check_divisible(n_nu, mesh)
    w_nu = trapz_weights(rcm.nu)
    rcm_s = shard_spectral(shard_lbl(rcm, mesh.shape["nu"]), mesh, n_nu)
    w_s = jax.device_put(w_nu, NamedSharding(mesh, P("nu")))
    rcm_specs = spectral_pspecs(rcm_s, n_nu)
    A_specs = spectral_pspecs(rcm_s.A, n_nu)

    def local(rcm_l, w_l, T, A_l):
        def spectral_sum(M):
            return lax.psum(jnp.sum(M * w_l, axis=-1), "nu")

        return rcm_mod.heating(rcm_l, T, A_l, spectral_sum=spectral_sum)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(rcm_specs, P("nu"), P(), A_specs),
        out_specs=P(),
    )
    jitted = jax.jit(fn)

    def heating_fn(T, A=None):
        return jitted(rcm_s, w_s, T, rcm_s.A if A is None else A)

    heating_fn.rcm_sharded = rcm_s
    # the underlying jitted program + its bound leading args, so callers can
    # lower/compile and audit the collective schedule (tests/test_parallel.py
    # asserts the one-psum-per-step claim from the compiled HLO)
    heating_fn.jitted = jitted
    heating_fn.bound_args = (rcm_s, w_s)
    return heating_fn


def make_sharded_step(mesh: Mesh, rcm, dt, update_every: int = 0):
    """Full sharded RCE step program: ``f(T, A, i) -> (T', A')``.

    One Euler step with the heating computed under ``shard_map`` (single psum
    over the 'nu' axis), plus an optional cached-cross-section refresh every
    ``update_every`` steps (local to each shard — cross-sections are
    per-wavenumber, so the update needs no communication at all).
    """
    n_nu = rcm.nu.shape[0]
    _check_divisible(n_nu, mesh)
    w_nu = trapz_weights(rcm.nu)
    rcm_s = shard_spectral(shard_lbl(rcm, mesh.shape["nu"]), mesh, n_nu)
    w_s = jax.device_put(w_nu, NamedSharding(mesh, P("nu")))
    rcm_specs = spectral_pspecs(rcm_s, n_nu)
    A_specs = spectral_pspecs(rcm_s.A, n_nu)
    lnPe, lnP = jnp.log(rcm.Pe), jnp.log(rcm.P)

    def local(rcm_l, w_l, T, A_l, i):
        def spectral_sum(M):
            return lax.psum(jnp.sum(M * w_l, axis=-1), "nu")

        H = rcm_mod.heating(rcm_l, T, A_l, spectral_sum=spectral_sum)
        T = T + dt * H
        if update_every:
            from ..utils.interp import interp_linear

            Te = interp_linear(lnPe, lnP, T)
            A_l = lax.cond(
                (i + 1) % update_every == 0,
                lambda a: a.update(Te),
                lambda a: a,
                A_l,
            )
        return T, A_l

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(rcm_specs, P("nu"), P(), A_specs, P()),
        out_specs=(P(), A_specs),
    )
    jitted = jax.jit(fn)

    def step_fn(T, A=None, i=0):
        return jitted(rcm_s, w_s, T, rcm_s.A if A is None else A, jnp.asarray(i))

    step_fn.rcm_sharded = rcm_s
    step_fn.jitted = jitted
    step_fn.bound_args = (rcm_s, w_s)
    return step_fn
