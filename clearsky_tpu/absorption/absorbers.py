"""Consolidated absorbers: the unified stack and the accelerated column cache.

Array-first re-design of ClearSky.jl ``src/absorbers.jl``. The reference's
``UnifiedAbsorber`` funnels every flux evaluation through a scalar accessor
``Σ(𝒜, i, T, P)`` (ref absorbers.jl:84-95) — one cross-section at a time.
Here the access pattern is inverted: an :class:`AbsorberStack` produces dense
``sigma[..., n_nu]`` blocks for whole batches of (T, P) states in one shot,
and an :class:`AcceleratedAbsorber` caches ``log sigma`` on the model's own
pressure column, updating with temperature in a single fused evaluation
(the reference's serial per-level loop, ref absorbers.jl:173-200, becomes one
device call).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.interp import interp_linear
from .gas import AbstractGas, Gas, DirectGas, MultiGas
from .cia import CIATables, BoundCIA, CIA

__all__ = [
    "AbsorberStack",
    "AcceleratedAbsorber",
    "unify_absorbers",
    "check_pressures",
    "pressure_limits",
    "temperature_limits",
]

_LOG_TINY = float(np.log(np.finfo(np.float64).tiny))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class AbsorberStack:
    """Unified absorber: gases + CIA pairs + user sigma(nu, T, P) functions.

    Equivalent of the reference's ``UnifiedAbsorber`` (ref absorbers.jl:11-101),
    with CIA tables automatically paired against the real gases
    (ref absorbers.jl:69) and identical-wavenumber-grid validation
    (ref absorbers.jl:226-235).
    """

    gases: tuple
    cias: tuple
    nu: jax.Array
    funs: tuple = dataclasses.field(metadata=dict(static=True), default=())

    @classmethod
    def create(cls, *absorbers) -> "AbsorberStack":
        if len(absorbers) == 1 and isinstance(absorbers[0], (tuple, list)):
            absorbers = tuple(absorbers[0])
        if len(absorbers) == 0:
            raise ValueError("no absorbers... nothing to group")
        if any(isinstance(a, (AbsorberStack, AcceleratedAbsorber)) for a in absorbers):
            if len(absorbers) == 1:
                return absorbers[0]
            raise ValueError("cannot mix consolidated absorbers with others")
        gases = tuple(a for a in absorbers if isinstance(a, AbstractGas))
        if not gases:
            raise ValueError(
                "must have at least one gas object, which specifies wavenumber samples"
            )
        raw_cias = [a for a in absorbers if isinstance(a, (CIATables, BoundCIA))]
        funs = tuple(
            a
            for a in absorbers
            if not isinstance(a, (AbstractGas, CIATables, BoundCIA))
        )
        for f in funs:
            if not callable(f):
                raise TypeError(
                    "absorbers must be gases, CIA objects, or callables sigma(nu, T, P)"
                )
        # identical wavenumber grids across gases (ref absorbers.jl:226-229)
        nu0 = np.asarray(gases[0].nu)
        for g in gases[1:]:
            if not np.array_equal(np.asarray(g.nu), nu0):
                raise ValueError("gases must have identical wavenumber vectors")
        realgases = tuple(g for g in gases if isinstance(g, (Gas, DirectGas)))
        # fused mixtures expose per-molecule component views so CIA pairing
        # by formula works through a MultiGas (ref absorbers.jl:69 pairing
        # semantics preserved at single-molecule granularity)
        for g in gases:
            if isinstance(g, MultiGas):
                realgases = realgases + g.components()
        cias = []
        for c in raw_cias:
            bound = c.bind(nu0) if isinstance(c, CIATables) else c
            cias.append(CIA.pair(bound, realgases))
        return cls(gases=gases, cias=tuple(cias), nu=jnp.asarray(nu0), funs=funs)

    @property
    def n_nu(self) -> int:
        return self.nu.shape[0]

    def sigma(self, T, P):
        """Total cross-section sigma[..., n_nu] [cm^2/molecule] at (T, P) arrays.

        The dense-array inversion of the reference's sigma chain
        (ref absorbers.jl:84-95).
        """
        T = jnp.asarray(T)
        P = jnp.asarray(P)
        total = jnp.zeros(jnp.broadcast_shapes(T.shape, P.shape) + (self.n_nu,))
        for g in self.gases:
            total = total + g(T, P)
        for c in self.cias:
            total = total + c.sigma(T, P)
        for f in self.funs:
            total = total + f(self.nu, T[..., None], P[..., None])
        return total

    def update(self, T):
        """No-op, for interface parity with AcceleratedAbsorber. Ref absorbers.jl:80."""
        return self


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class AcceleratedAbsorber:
    """Per-column cached cross-sections: log sigma on the model's own lnP grid.

    Equivalent of the reference's ``AcceleratedAbsorber``
    (ref absorbers.jl:106-209): built by evaluating the full stack at the
    column's (T, P) pairs; evaluation interpolates log sigma linearly in lnP;
    ``update`` re-evaluates for a new temperature profile. Functional — update
    returns a new instance (one fused device call instead of the reference's
    serial per-level loop, ref absorbers.jl:176).
    """

    ln_sigma: jax.Array   # [np_col, n_nu]
    lnP: jax.Array        # [np_col]
    T: jax.Array          # [np_col]
    nu: jax.Array
    stack: AbsorberStack

    @classmethod
    def create(cls, T, P, *absorbers) -> "AcceleratedAbsorber":
        stack = unify_absorbers(absorbers)
        P = jnp.asarray(P)
        T = jnp.asarray(T)
        idx = jnp.argsort(P)
        P = P[idx]
        T = T[idx]
        inst = cls(
            ln_sigma=jnp.zeros((P.shape[0], stack.n_nu)),
            lnP=jnp.log(P),
            T=T,
            nu=stack.nu,
            stack=stack,
        )
        return inst.update(T)

    @property
    def n_nu(self) -> int:
        return self.nu.shape[0]

    def update(self, T) -> "AcceleratedAbsorber":
        """Re-evaluate cached cross-sections for a new temperature profile.

        Ref absorbers.jl:173-200, with the log-tiny floor of ref :187-195.
        """
        T = jnp.asarray(T)
        sig = self.stack.sigma(T, jnp.exp(self.lnP))
        # log(max(sig, dtype tiny)) >= log(tiny) >= _LOG_TINY already, so no
        # second floor is needed after the select
        ln = jnp.where(sig > 0, jnp.log(jnp.maximum(sig, jnp.finfo(sig.dtype).tiny)), _LOG_TINY)
        return dataclasses.replace(self, ln_sigma=ln, T=T)

    def sigma(self, T, P):
        """Total cross-section [..., n_nu]; T is ignored (cached), ref absorbers.jl:203."""
        P = jnp.asarray(P)
        v = interp_linear(jnp.log(P), self.lnP, jnp.moveaxis(self.ln_sigma, 0, -1))
        return jnp.exp(jnp.moveaxis(v, 0, -1))


def unify_absorbers(absorbers) -> AbsorberStack | AcceleratedAbsorber:
    """Normalize user absorber inputs. Ref absorbers.jl:214-223."""
    if isinstance(absorbers, (AbsorberStack, AcceleratedAbsorber)):
        return absorbers
    if isinstance(absorbers, (tuple, list)):
        if len(absorbers) == 1 and isinstance(
            absorbers[0], (AbsorberStack, AcceleratedAbsorber)
        ):
            return absorbers[0]
        return AbsorberStack.create(*absorbers)
    return AbsorberStack.create(absorbers)


def pressure_limits(stack) -> tuple[float, float]:
    """Intersection of gas table pressure domains. Ref absorbers.jl:248-256."""
    if isinstance(stack, AcceleratedAbsorber):
        stack = stack.stack
    gs = [g for g in stack.gases if isinstance(g, Gas)]
    if not gs:
        return 0.0, np.inf
    return (
        max(g.domain.Pmin for g in gs),
        min(g.domain.Pmax for g in gs),
    )


def temperature_limits(stack) -> tuple[float, float]:
    """Intersection of gas table temperature domains. Ref absorbers.jl:258-266."""
    if isinstance(stack, AcceleratedAbsorber):
        stack = stack.stack
    gs = [g for g in stack.gases if isinstance(g, Gas)]
    if not gs:
        return 0.0, np.inf
    return (
        max(g.domain.Tmin for g in gs),
        min(g.domain.Tmax for g in gs),
    )


def check_pressures(stack, Ps, Pt):
    """Domain guard for pressure endpoints. Ref absorbers.jl:237-246."""
    if not Ps > Pt:
        raise ValueError("Ps must be greater than Pt")
    Pmin, Pmax = pressure_limits(stack)
    for P in (Ps, Pt):
        if P < Pmin:
            raise ValueError(f"Pressure {P} Pa too low, gas table domain minimum is {Pmin}")
        if P > Pmax:
            raise ValueError(f"Pressure {P} Pa too high, gas table domain maximum is {Pmax}")
