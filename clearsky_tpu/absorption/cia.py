"""Collision-induced absorption (CIA): HITRAN ``.cia`` ingestion and evaluation.

Array-first equivalent of ClearSky.jl ``src/absorption/collision_induced_absorption.jl``.
The reference wraps each (wavenumber-range, temperature) grid in a bilinear
interpolator of log k and sums ranges per scalar query. Here ingestion happens
host-side once, log k is resampled onto the model's *static* wavenumber grid
at bind time (linear in nu — identical to the reference's bilinear order), and
runtime evaluation reduces to a 1-D temperature interpolation per range: pure
dense elementwise work over the whole spectrum at once.

The cross-section conversion follows the reference's *correct* code path
(the CIA-object path, ref :378-382 -> :318-323 -> :295-303). The reference's
vector ``cia!`` wrapper permutes its partial-pressure arguments
(ref :339-343,359-363, a bug flagged in SURVEY.md); that behavior is
deliberately not replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import P_ATM, T_ICE, K_BOLTZ, LOSCHMIDT

_LOG_LOSCHMIDT = float(np.log(LOSCHMIDT))
from ..utils.interp import interp_linear

__all__ = ["read_cia", "CIATables", "BoundCIA", "CIA", "cia_xsec", "cia_xsec_scaled"]

_TINY = np.finfo(np.float64).tiny


def read_cia(filename: str) -> list[dict]:
    """Parse a HITRAN .cia file into a list of per-(range, T) dicts.

    Ref collision_induced_absorption.jl:39-94. Header lines are exactly 100
    characters with fixed-width fields; data lines hold (nu, k) pairs.
    """
    if not str(filename).endswith(".cia"):
        raise ValueError(
            "expected file with .cia extension downloaded from https://hitran.org/cia/"
        )
    with open(filename) as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    lens = np.array([len(ln) for ln in lines])
    if lens.max(initial=0) != 100:
        raise ValueError(
            f"unexpected maximum line length in cia file, expected 100 got {lens.max()}"
        )
    hidx = list(np.flatnonzero(lens == 100)) + [len(lines)]
    data = []
    for a, b in zip(hidx[:-1], hidx[1:]):
        line = lines[a]
        rec = {
            "symbol": line[0:20].strip(),
            "numin": float(line[20:30]),
            "numax": float(line[30:40]),
            "npts": int(line[40:47]),
            "T": float(line[47:54]),
            "maxcia": float(line[54:64]),
            "res": float(line[64:70]) if line[64:70].strip() else np.nan,
            "comments": line[70:97].strip(),
            "reference": int(line[97:100]) if line[97:100].strip() else 0,
        }
        table = np.array(
            [ln.split()[:2] for ln in lines[a + 1 : b] if ln.strip()], dtype=np.float64
        )
        rec["nu"] = table[:, 0]
        rec["k"] = table[:, 1]
        data.append(rec)
    return data


@dataclasses.dataclass(frozen=True, eq=False)
class CIATables:
    """Host-side grouped CIA data. Ref collision_induced_absorption.jl:145-242.

    ``grids``: list of (nu[n], T[m], logk[n, m]) for multi-temperature ranges.
    ``singles``: list of (nu[n], logk[n], T) for single-temperature ranges.
    """

    name: str
    formulae: tuple[str, str]
    grids: tuple
    singles_data: tuple
    extrapolate: bool = False
    singles: bool = False

    @classmethod
    def from_data(
        cls, data: list[dict], extrapolate: bool = False, singles: bool = False
    ) -> "CIATables":
        numin = np.array([d["numin"] for d in data])
        numax = np.array([d["numax"] for d in data])
        ranges = sorted(set(zip(numin, numax)), key=lambda t: t[0])
        grids, single_list = [], []
        for rmin, rmax in ranges:
            idx = [
                i
                for i in range(len(data))
                if np.isclose(numin[i], rmin) and np.isclose(numax[i], rmax)
            ]
            Ts = np.array([data[i]["T"] for i in idx])
            if len(idx) == 1:
                d = data[idx[0]]
                k = np.maximum(d["k"], 0.0)
                k = np.where(k <= 0.0, _TINY, k)
                single_list.append((d["nu"], np.log(k), float(Ts[0])))
            else:
                nus = [data[i]["nu"] for i in idx]
                for other in nus[1:]:
                    if len(other) != len(nus[0]) or not np.allclose(other, nus[0]):
                        raise ValueError(
                            "wavenumber samples within a range appear to be different"
                        )
                order = np.argsort(Ts)
                kmat = np.stack([data[idx[j]]["k"] for j in order], axis=1)  # [n, m]
                kmat = np.where(kmat <= 0.0, _TINY, kmat)
                grids.append((nus[0], Ts[order], np.log(kmat)))
        symbols = {d["symbol"] for d in data}
        if len(symbols) != 1:
            raise ValueError("mixed symbols in cia data")
        symbol = symbols.pop()
        formulae = tuple(symbol.split("-"))
        return cls(
            name=symbol,
            formulae=formulae,
            grids=tuple(grids),
            singles_data=tuple(single_list),
            extrapolate=extrapolate,
            singles=singles,
        )

    @classmethod
    def from_file(cls, filename: str, extrapolate: bool = False, singles: bool = False):
        return cls.from_data(read_cia(filename), extrapolate=extrapolate, singles=singles)

    def __call__(self, nu, T):
        """Host-side scalar evaluation of k [cm^5/molecule^2]. Ref :251-276."""
        k = 0.0
        for gnu, gT, glogk in self.grids:
            if gnu[0] <= nu <= gnu[-1]:
                Tq = np.clip(T, gT[0], gT[-1]) if self.extrapolate else T
                if gT[0] <= Tq <= gT[-1]:
                    i = np.clip(np.searchsorted(gnu, nu, "right") - 1, 0, len(gnu) - 2)
                    j = np.clip(np.searchsorted(gT, Tq, "right") - 1, 0, len(gT) - 2)
                    tx = (nu - gnu[i]) / (gnu[i + 1] - gnu[i])
                    ty = (Tq - gT[j]) / (gT[j + 1] - gT[j])
                    v = (
                        glogk[i, j] * (1 - tx) * (1 - ty)
                        + glogk[i + 1, j] * tx * (1 - ty)
                        + glogk[i, j + 1] * (1 - tx) * ty
                        + glogk[i + 1, j + 1] * tx * ty
                    )
                    k += np.exp(v)
        if self.singles:
            for snu, slogk, _ in self.singles_data:
                if snu[0] <= nu <= snu[-1]:
                    k += np.exp(np.interp(nu, snu, slogk))
        return k

    def bind(self, nu_grid: np.ndarray) -> "BoundCIA":
        """Resample onto a static wavenumber grid for device evaluation."""
        nu_grid = np.asarray(nu_grid, dtype=np.float64)
        logk_grids, T_grids, masks = [], [], []
        for gnu, gT, glogk in self.grids:
            mask = (nu_grid >= gnu[0]) & (nu_grid <= gnu[-1])
            res = np.empty((len(gT), len(nu_grid)))
            for j in range(len(gT)):
                res[j] = np.interp(nu_grid, gnu, glogk[:, j])
            logk_grids.append(jnp.asarray(res))
            T_grids.append(jnp.asarray(gT))
            masks.append(jnp.asarray(mask))
        s_logk, s_masks = [], []
        for snu, slogk, _ in self.singles_data:
            mask = (nu_grid >= snu[0]) & (nu_grid <= snu[-1])
            s_logk.append(jnp.asarray(np.interp(nu_grid, snu, slogk)))
            s_masks.append(jnp.asarray(mask))
        return BoundCIA(
            logk=tuple(logk_grids),
            T=tuple(T_grids),
            mask=tuple(masks),
            s_logk=tuple(s_logk),
            s_mask=tuple(s_masks),
            name=self.name,
            formulae=self.formulae,
            extrapolate=self.extrapolate,
            use_singles=self.singles,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class BoundCIA:
    """CIA absorption-coefficient tables bound to a static wavenumber grid."""

    logk: tuple          # per multi-T range: [mT, n_nu]
    T: tuple             # per range: [mT]
    mask: tuple          # per range: [n_nu] bool
    s_logk: tuple        # per single range: [n_nu]
    s_mask: tuple        # per single range: [n_nu] bool
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    formulae: tuple = dataclasses.field(metadata=dict(static=True), default=("", ""))
    extrapolate: bool = dataclasses.field(metadata=dict(static=True), default=False)
    use_singles: bool = dataclasses.field(metadata=dict(static=True), default=False)

    def k(self, T, scale: float = 0.0):
        """Absorption coefficient k[..., n_nu] [cm^5/molecule^2] at temperature T [...].

        Device equivalent of the reference's per-scalar summed interpolation
        (ref :251-276): every containing range contributes exp(interp(log k)).

        ``scale`` is added INSIDE the exponent: k values are ~1e-44
        cm^5/molecule^2 — BELOW the float32 normal range (1.2e-38), so
        ``exp(log k)`` flushes to zero on f32 hardware and the whole CIA
        contribution silently vanishes (found in round 4: the f32 config-4
        column lost 24 W/m^2 of window-region downwelling to exactly this).
        Callers that need f32 safety pass ``scale=ln(LOSCHMIDT)`` and work
        with k*Lo (~1e-25, comfortably normal); see :func:`cia_xsec`.
        """
        T = jnp.asarray(T)
        n_nu = (self.mask[0] if self.mask else self.s_mask[0]).shape[0]
        total = jnp.zeros(T.shape + (n_nu,))
        for logk, Tr, m in zip(self.logk, self.T, self.mask):
            # interp in T along the last axis of [n_nu, mT]; result [n_nu, ...T]
            v = interp_linear(T, Tr, jnp.moveaxis(logk, 0, -1), extrapolate=False)
            v = jnp.moveaxis(v, 0, -1)  # -> [...T, n_nu]
            contrib = jnp.exp(v + scale)
            if not self.extrapolate:
                in_T = (T >= Tr[0]) & (T <= Tr[-1])
                contrib = jnp.where(in_T[..., None], contrib, 0.0)
            total = total + jnp.where(m, contrib, 0.0)
        if self.use_singles:
            for slogk, sm in zip(self.s_logk, self.s_mask):
                contrib = jnp.broadcast_to(jnp.exp(slogk + scale),
                                           T.shape + slogk.shape)
                total = total + jnp.where(sm, contrib, 0.0)
        return total


def cia_xsec(k, T, Pa, P1, P2):
    """CIA cross-section [cm^2/molecule] from absorption coefficient k.

    Amagat conversion, ref collision_induced_absorption.jl:295-303:
    rho_i = (P_i/atm)(273.15/T) [amagat], rho_a = 1e-6 P_a/(kB T) [molec/cm^3],
    sigma = k * Lo^2 * rho1 * rho2 / rho_a.
    """
    rho1 = (P1 / P_ATM) * (T_ICE / T)
    rho2 = (P2 / P_ATM) * (T_ICE / T)
    rho_a = 1e-6 * Pa / (K_BOLTZ * T)
    # float32-safe ordering: Lo^2 = 7.2e38 overflows f32 (max 3.4e38), which
    # NaN'd the whole CIA path in float32; k*Lo (~1e-26) and Lo/rho_a (~1e-6 at
    # surface conditions) are both representable, so apply Lo twice
    return ((k * LOSCHMIDT) * (LOSCHMIDT / rho_a)) * rho1 * rho2


def cia_xsec_scaled(kLo, T, Pa, P1, P2):
    """:func:`cia_xsec` taking the PRE-SCALED k*Lo (from ``BoundCIA.k(T,
    scale=log(LOSCHMIDT))``) — the float32-safe production path: the raw k
    (~1e-44 cm^5/molecule^2) sits below the f32 normal range and flushes to
    zero if ever materialized."""
    rho1 = (P1 / P_ATM) * (T_ICE / T)
    rho2 = (P2 / P_ATM) * (T_ICE / T)
    rho_a = 1e-6 * Pa / (K_BOLTZ * T)
    return (kLo * (LOSCHMIDT / rho_a)) * rho1 * rho2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class CIA:
    """A BoundCIA paired with its two component gases. Ref :431-465.

    Partial pressures come from the gases' stored concentration functions,
    following the reference's correct CIA-object evaluation path (ref :465 ->
    :378-382 -> :318-323).
    """

    tables: BoundCIA
    g1: object
    g2: object
    name: str = dataclasses.field(metadata=dict(static=True), default="")

    @classmethod
    def pair(cls, tables: BoundCIA, gases) -> "CIA":
        """Auto-pair a CIA table with the matching gases. Ref :445-463.

        Only the paired gases' formulae and concentration functions are
        needed (the amagat conversion, ref :295-303), so the pair stores
        lightweight :class:`~.gas.GasComponent` views — fused ``MultiGas``
        mixtures expose their per-molecule components the same way, and the
        spectral-sharding tree rewrite never duplicates line catalogs into
        CIA pairs.
        """
        from .gas import GasComponent

        f1, f2 = tables.formulae

        def find(f):
            matches = [g for g in gases if getattr(g, "formula", None) == f]
            if len(matches) == 0:
                raise ValueError(f"pairing failed for {tables.name} CIA, gas {f} missing")
            if len(matches) > 1:
                raise ValueError(f"pairing failed for {tables.name} CIA, duplicate {f}")
            g = matches[0]
            if isinstance(g, GasComponent):
                return g
            return GasComponent(
                formula=g.formula, name=getattr(g, "name", g.formula), fC=g.fC
            )

        return cls(tables=tables, g1=find(f1), g2=find(f2), name=tables.name)

    def sigma(self, T, P):
        """CIA cross-section contribution [..., n_nu] at (T, P) arrays."""
        T = jnp.asarray(T)
        P = jnp.asarray(P)
        kLo = self.tables.k(T, scale=_LOG_LOSCHMIDT)
        P1 = P * jnp.asarray(self.g1.concentration(T, P))
        P2 = P * jnp.asarray(self.g2.concentration(T, P))
        return cia_xsec_scaled(kLo, T[..., None], P[..., None], P1[..., None],
                               P2[..., None])
