"""nu-sharded line-by-line opacity: per-shard line slabs with cut-width halos.

The reference threads real-gas flux solves over the wavenumber axis
(ClearSky.jl ``fluxes.jl:270`` with the moving line window
``line_shapes.jl:10-22``); the accelerator equivalent shards the wavenumber
grid in contiguous blocks across devices. Because the line window couples each grid
point to lines within ``cut`` of it, a shard's line set is the compact slab
``[nu_shard_min - cut, nu_shard_max + cut]`` — the halo is folded into
overlapping *static* slabs at construction time, so the sharded evaluation
needs **zero communication** (SURVEY.md §5 "long-context" design).

:class:`ShardedLineGas` carries, stacked along a leading shard axis,

* the per-shard padded line-slab catalog (a :class:`SpectralLines` whose
  per-line leaves are [n_shards, L_pad]),
* a per-shard banding plan (:class:`DeviceWindowPlan` with leaves
  [n_shards, ...]),

and evaluates shard-locally. Placed on a mesh with the leading axis sharded
over ``'nu'`` (see :meth:`ShardedLineGas.pspecs`), each device holds exactly
its own slab + plan; inside ``shard_map`` the local leading dimension is 1 and
``raw_sigma`` produces the local [..., n_nu/n_shards] block. On a single
device the same loop over all shards reproduces the unsharded ``DirectGas``/
``MultiGas`` physics (the equivalence is tested on the 8-device CPU mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.linesum import (
    DeviceWindowPlan,
    build_line_window_plan,
    sigma_from_lines_auto_device,
    split_f64,
)
from ..spectra.lines import SpectralLines, PER_LINE_FIELDS
from .gas import AbstractGas, DirectGas, MultiGas

__all__ = ["ShardedLineGas", "shard_line_gas"]

_PAD = 128  # line-slab length alignment

_LINE_FIELDS = PER_LINE_FIELDS  # canonical list lives on spectra.lines
# inert padding: far-away position (window mask kills it), zero strength,
# harmless broadening parameters, valid TIPS row
_PAD_VALUES = dict(
    nu=1e30, nu_lo=0.0, S=0.0, ga=0.0, gs=0.0, Epp=0.0, na=0.0,
    mu=1.0, A=1.0, iso=1, iso_ptr=0,
)


def _slice_lines(lines: SpectralLines, s) -> SpectralLines:
    """Shard-local view of a stacked catalog (tips_coeffs is shared)."""
    return dataclasses.replace(
        lines, **{f: getattr(lines, f)[s] for f in _LINE_FIELDS}
    )


def _slice_plan(plans: DeviceWindowPlan, s) -> DeviceWindowPlan:
    return dataclasses.replace(
        plans,
        nu_blocks=plans.nu_blocks[s],
        nu_blocks_lo=plans.nu_blocks_lo[s],
        start=plans.start[s],
        count=plans.count[s],
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLineGas(AbstractGas):
    """Line-by-line gas with per-spectral-shard line slabs and banding plans.

    Built from a :class:`DirectGas` or :class:`MultiGas` by
    :func:`shard_line_gas`. ``conc`` is the stacked per-line concentration of
    a fused multi-molecule catalog (None for single-molecule gases, whose
    concentration comes from ``fC``); ``fCs``/``mol_ptr`` carry
    state-dependent per-molecule concentrations when present (see
    ``MultiGas``).
    """

    lines: SpectralLines          # leaves stacked [n_shards, L_pad]
    plans: DeviceWindowPlan       # leaves stacked [n_shards, ...]
    nu: jax.Array                 # [n_nu] global wavenumber grid
    conc: jax.Array | None = None     # [n_shards, L_pad] per-line concentration
    mol_ptr: jax.Array | None = None  # [n_shards, L_pad] molecule index
    shape: str = dataclasses.field(metadata=dict(static=True), default="voigt")
    fC: Callable = dataclasses.field(metadata=dict(static=True), default=None)
    fCs: tuple = dataclasses.field(metadata=dict(static=True), default=())
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    formula: str = dataclasses.field(metadata=dict(static=True), default="")
    mu: float = dataclasses.field(metadata=dict(static=True), default=float("nan"))
    n_shards: int = dataclasses.field(metadata=dict(static=True), default=1)

    @property
    def k_local(self) -> int:
        """Number of shards held locally (n_shards globally, 1 in shard_map)."""
        return self.plans.start.shape[0]

    def _conc_local(self, s, T, P):
        """Per-line concentration array for shard s, or None."""
        if self.mol_ptr is not None:
            # state-dependent per-molecule concentrations, gathered per line
            cs = jnp.stack(
                [jnp.asarray(f(T, P)) for f in self.fCs], axis=-1
            )  # [..., n_mols]
            return jnp.take(cs, self.mol_ptr[s].astype(jnp.int32), axis=-1)
        if self.conc is not None:
            return self.conc[s]
        return None

    def raw_sigma(self, T, P):
        """Cross-sections [..., n_nu_local * k_local]: shard-local evaluation.

        Under ``shard_map`` (k_local == 1) this is the shard's own contiguous
        block of the spectrum; on a single device the loop over all shards
        concatenates to the full grid, matching ``DirectGas.raw_sigma``.
        """
        T = jnp.asarray(T)
        P = jnp.asarray(P)
        if self.conc is None and self.mol_ptr is None:
            C = jnp.asarray(self.fC(T, P))
            Pp = C * P
        else:
            Pp = None
        outs = []
        for s in range(self.k_local):
            sig = sigma_from_lines_auto_device(
                _slice_plan(self.plans, s),
                _slice_lines(self.lines, s),
                T, P, Pp, self.shape,
                conc=self._conc_local(s, T, P),
            )
            outs.append(sig)
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)

    def concentration(self, T, P):
        """Ref gases.jl:270; unity when concentrations are folded per line."""
        if self.conc is not None or self.mol_ptr is not None:
            return jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))
        return self.fC(T, P)

    def __call__(self, T, P):
        if self.conc is not None or self.mol_ptr is not None:
            return self.raw_sigma(T, P)  # already concentration-scaled
        return super().__call__(T, P)

    def reconcentrate(self, fC) -> "ShardedLineGas":
        if self.conc is not None or self.mol_ptr is not None:
            raise ValueError(
                "cannot reconcentrate a fused multi-molecule sharded gas"
            )
        from .gas import as_concentration

        return dataclasses.replace(self, fC=as_concentration(fC))

    def pspecs(self):
        """PartitionSpec tree placing the shard axis on the 'nu' mesh axis.

        Matching structure for ``shard_map`` in_specs / ``device_put``: every
        stacked leaf gets P('nu', None, ...), the shared TIPS table and the
        global grid's last axis follow the standard spectral convention.
        """
        from jax.sharding import PartitionSpec as P

        def stacked(x):
            return P(*(("nu",) + (None,) * (np.ndim(x) - 1)))

        lines_spec = dataclasses.replace(
            self.lines,
            **{f: stacked(getattr(self.lines, f)) for f in _LINE_FIELDS},
            tips_coeffs=P(),
        )
        plans_spec = dataclasses.replace(
            self.plans,
            nu_blocks=P("nu", None, None),
            nu_blocks_lo=P("nu", None, None),
            start=P("nu", None),
            count=P("nu", None),
        )
        return dataclasses.replace(
            self,
            lines=lines_spec,
            plans=plans_spec,
            nu=P("nu"),
            conc=None if self.conc is None else P("nu", None),
            mol_ptr=None if self.mol_ptr is None else P("nu", None),
        )

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"ShardedLineGas({self.name} [{self.formula}], n_shards={self.n_shards}, "
            f"n_nu={self.nu.shape[0]}, slab_pad={self.lines.nu.shape[-1]})"
        )


def shard_line_gas(gas, n_shards: int, block: int | None = None) -> ShardedLineGas:
    """Split a DirectGas/MultiGas into ``n_shards`` contiguous spectral shards.

    Host-side, setup time: for each shard the line slab
    ``[nu_min - cut, nu_max + cut]`` is located with ``searchsorted`` (the
    halo of SURVEY.md §5 folded into static overlapping slabs), a local
    banding plan is built against the slab-local catalog, and everything is
    stacked along a leading shard axis so the result shards over the 'nu'
    mesh axis with zero runtime communication.
    """
    if isinstance(gas, ShardedLineGas):
        if gas.n_shards == n_shards:
            return gas
        raise ValueError(
            f"gas already sharded {gas.n_shards}-way, cannot re-shard to {n_shards}"
        )
    if not isinstance(gas, (DirectGas, MultiGas)):
        raise TypeError("shard_line_gas requires a DirectGas or MultiGas")
    # rebuild from the PLAN's grid, not gas.nu: the device array is f32 when
    # x64 is off (as on the GPU), and f32-rounded block positions (~5e-4
    # cm^-1 at 1e4 cm^-1) shift the per-shard plans' two-float block centers
    # off the static plan's — flipping line membership at the |dnu| = cut
    # boundary and biasing deep-wing sigma by O(10%) of its (tiny) value. The
    # plan keeps the constructor's float64 grid exactly for this purpose.
    nu = np.asarray(gas.plan.nu, np.float64)
    n_nu = len(nu)
    if n_nu % n_shards != 0:
        raise ValueError(
            f"n_nu={n_nu} not divisible by n_shards={n_shards}; pad the grid"
        )
    n_local = n_nu // n_shards
    cut = float(gas.plan.cut)
    block = int(gas.plan.block if block is None else block)
    lines = gas.lines
    nu_l = np.asarray(lines.nu, np.float64)

    bounds, plans = [], []
    for s in range(n_shards):
        nus = nu[s * n_local : (s + 1) * n_local]
        a = int(np.searchsorted(nu_l, nus[0] - cut, side="left"))
        b = int(np.searchsorted(nu_l, nus[-1] + cut, side="right"))
        # lineless shards (grid extending > cut beyond the catalog) keep one
        # count-masked line for static shapes; clamp a BEFORE widening b so a
        # shard above the whole catalog (a == b == n_lines) stays in range
        a = min(a, len(nu_l) - 1)
        b = max(b, a + 1)
        bounds.append((a, b))
        plans.append(build_line_window_plan(nus, nu_l[a:b], cut, block=block))

    L = max(b - a for a, b in bounds)
    L_pad = -(-L // _PAD) * _PAD
    slab = max(p.slab for p in plans)
    nb, B = plans[0].n_blocks, plans[0].block

    nb64 = np.stack([np.asarray(p.nu_blocks, np.float64) for p in plans])
    dplans = DeviceWindowPlan(
        nu_blocks=jnp.asarray(nb64),
        nu_blocks_lo=jnp.asarray(split_f64(nb64)[1]),
        start=jnp.asarray(np.stack([p.start for p in plans]), jnp.int32),
        count=jnp.asarray(np.stack([p.count for p in plans]), jnp.int32),
        cut=cut,
        block=B,
        n_blocks=nb,
        slab=int(slab),
        n_nu=n_local,
    )

    def stack_field(name):
        x = np.asarray(getattr(lines, name))
        out = np.full((n_shards, L_pad), _PAD_VALUES[name], dtype=x.dtype)
        for s, (a, b) in enumerate(bounds):
            out[s, : b - a] = x[a:b]
        return jnp.asarray(out)

    lines_s = dataclasses.replace(
        lines, **{f: stack_field(f) for f in _LINE_FIELDS}
    )

    def stack_per_line(x, fill=0.0):
        x = np.asarray(x)
        out = np.full((n_shards, L_pad), fill, dtype=x.dtype)
        for s, (a, b) in enumerate(bounds):
            out[s, : b - a] = x[a:b]
        return jnp.asarray(out)

    conc = getattr(gas, "conc", None)
    mol_ptr = getattr(gas, "mol_ptr", None)
    return ShardedLineGas(
        lines=lines_s,
        plans=dplans,
        nu=jnp.asarray(nu),
        conc=None if conc is None else stack_per_line(conc),
        mol_ptr=None if mol_ptr is None else stack_per_line(mol_ptr, 0),
        shape=gas.shape,
        fC=getattr(gas, "fC", None),
        fCs=tuple(getattr(gas, "fCs", ()) or ()),
        name=gas.name,
        formula=gas.formula,
        mu=gas.mu,
        n_shards=n_shards,
    )
