"""Seeded synthetic line catalogs shaped like HITRAN CO2 and H2O.

The benchmark, the smoke run and the tests need line catalogs of realistic
size and structure without reading HITRAN files. This module builds them
from a seed: a ``read_par``-style dict passed through
:meth:`SpectralLines.from_par_dict`, so everything downstream (TIPS
scaling, isotopologue masses, sorting, two-float positions) is the
production path. Nothing is written to disk or downloaded.

assumed:
  * CO2 (5,599 lines): P and R branches of vibrational sub-bands around the
    667, 961, 1064, 2349 and 3715 cm^-1 bands. Only even J (the 16O12C16O
    ground state), so neighbouring lines of one branch sit ~4B = 1.56 cm^-1
    apart; B' < B'' makes the R branch turn back at a band head
    (nu = nu0 + (B' + B'') m + (B' - B'') m^2). Sub-bands (hot bands,
    isotopologues) are offset from the band centre by up to +-30 cm^-1.
    Per-block line counts on the 131,072-point grid spanning the catalog
    +-25 cm^-1 (cut 25): quartiles [0, 0, 0, 66, 952] at seed 0, beside
    [0, 1, 7, 25, 445] for the HITRAN CO2 test catalog: emptier between
    the bands, denser inside them.
  * H2O (3,058 lines): positions drawn irregularly (uniform) over
    0-1000, 1300-2000 and 3400-4000 cm^-1, 45/35/20 percent of the lines.
  * S log-uniform over 10 decades: 1e-29 to 1e-19 cm/molecule for H2O;
    for CO2 a sub-band strength log-uniform over 1e-26 to 1e-18 times the
    rotational Boltzmann envelope of its branch at 296 K, floored at 1e-2
    of the branch peak (1e-28 to 1e-18 in all).
  * gamma_air uniform 0.05-0.09, gamma_self 0.07-0.11 cm^-1/atm, n_air
    0.6-0.8, E'' uniform 0-3000 cm^-1 (CO2: rotational energy B J(J+1)
    plus a per-sub-band vibrational energy, clipped to 3000).
  * isotopologues 1-3 only (all have TIPS fits), 90/7/3 percent.
"""

from __future__ import annotations

import numpy as np

from .lines import SpectralLines

__all__ = ["synthetic_par", "synthetic_lines", "CO2_BANDS", "N_LINES"]

N_LINES = {"CO2": 5599, "H2O": 3058}
CO2_BANDS = (667.0, 961.0, 1064.0, 2349.0, 3715.0)
# share of CO2 sub-bands per band centre (the 15 um band is the busiest)
_CO2_BAND_WEIGHTS = (0.34, 0.11, 0.11, 0.29, 0.15)
_H2O_REGIONS = ((0.5, 1000.0, 0.45), (1300.0, 2000.0, 0.35), (3400.0, 4000.0, 0.20))
_MOLECULE = {"CO2": 2, "H2O": 1}
_B_ROT = 0.39  # CO2 ground-state rotational constant [cm^-1]


def _common(rng, n, S_lo, S_hi):
    return dict(
        S=10.0 ** rng.uniform(np.log10(S_lo), np.log10(S_hi), n),
        ga=rng.uniform(0.05, 0.09, n),
        gs=rng.uniform(0.07, 0.11, n),
        na=rng.uniform(0.6, 0.8, n),
        I=rng.choice(np.array(["1", "2", "3"]), size=n, p=[0.90, 0.07, 0.03]),
    )


def _co2(rng):
    n_target = N_LINES["CO2"]
    nu, Epp, env = [], [], []
    count = 0
    while count < n_target:
        band = rng.choice(len(CO2_BANDS), p=_CO2_BAND_WEIGHTS)
        nu0 = CO2_BANDS[band] + rng.uniform(-30.0, 30.0)
        Bpp = _B_ROT * rng.uniform(0.99, 1.01)
        Bp = Bpp * (1.0 - rng.uniform(0.002, 0.008))
        e_vib = rng.uniform(0.0, 2000.0)
        s_band = 10.0 ** rng.uniform(-26.0, -18.0)
        jmax = int(rng.integers(40, 70)) * 2
        J = np.arange(0, jmax + 1, 2, dtype=np.float64)
        for m in (J + 1.0, -J[J > 0]):  # R branch, then P branch
            pos = nu0 + (Bp + Bpp) * m + (Bp - Bpp) * m * m
            Jl = np.where(m > 0, m - 1.0, -m)
            nu.append(pos)
            Epp.append(np.minimum(Bpp * Jl * (Jl + 1.0) + e_vib, 3000.0))
            boltz = (2.0 * Jl + 1.0) * np.exp(
                -1.4387768775 * Bpp * Jl * (Jl + 1.0) / 296.0)
            env.append(s_band * np.maximum(boltz / boltz.max(), 1e-2))
            count += len(pos)
    nu = np.concatenate(nu)[:n_target]
    Epp = np.concatenate(Epp)[:n_target]
    env = np.concatenate(env)[:n_target]
    par = _common(rng, n_target, 1e-28, 1e-18)
    par.update(nu=nu, Epp=Epp, S=env)
    return par


def _h2o(rng):
    n = N_LINES["H2O"]
    k = rng.choice(len(_H2O_REGIONS), size=n, p=[w for *_, w in _H2O_REGIONS])
    lo = np.array([r[0] for r in _H2O_REGIONS])[k]
    hi = np.array([r[1] for r in _H2O_REGIONS])[k]
    par = _common(rng, n, 1e-29, 1e-19)
    par.update(nu=rng.uniform(lo, hi), Epp=rng.uniform(0.0, 3000.0, n))
    return par


def synthetic_par(molecule: str = "CO2", seed: int = 0,
                  maxlines: int | None = None) -> dict:
    """A ``read_par``-style dict (numeric columns) for ``molecule``.

    ``maxlines`` keeps only the strongest lines, as ``read_par`` does."""
    if molecule not in _MOLECULE:
        raise ValueError(f"no synthetic catalog for {molecule!r}; "
                         f"choose from {sorted(_MOLECULE)}")
    rng = np.random.default_rng([seed, _MOLECULE[molecule]])
    par = _co2(rng) if molecule == "CO2" else _h2o(rng)
    if maxlines is not None and maxlines < len(par["nu"]):
        keep = np.sort(np.argsort(-par["S"], kind="stable")[:maxlines])
        par = {k: v[keep] for k, v in par.items()}
    n = len(par["nu"])
    par.update(
        M=np.full(n, _MOLECULE[molecule], dtype=np.int64),
        A=np.zeros(n),
        da=np.zeros(n),
    )
    return par


def synthetic_lines(molecule: str = "CO2", seed: int = 0,
                    maxlines: int | None = None) -> SpectralLines:
    """Seeded synthetic :class:`SpectralLines` (see the module docstring)."""
    return SpectralLines.from_par_dict(synthetic_par(molecule, seed, maxlines))
