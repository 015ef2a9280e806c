"""The seeded synthetic line catalogs (spectra.synthetic)."""

import numpy as np
import pytest

from clearsky_tpu.ops.linesum import build_line_window_plan
from clearsky_tpu.spectra.synthetic import (
    CO2_BANDS, N_LINES, synthetic_lines, synthetic_par)


@pytest.mark.parametrize("molecule", ["CO2", "H2O"])
def test_same_seed_same_catalog(molecule):
    a = synthetic_par(molecule, seed=3)
    b = synthetic_par(molecule, seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = synthetic_par(molecule, seed=4)
    assert not np.array_equal(a["nu"], c["nu"])


@pytest.mark.parametrize("molecule", ["CO2", "H2O"])
def test_catalog_size_and_parameter_ranges(molecule):
    lines = synthetic_lines(molecule, seed=0)
    assert lines.n_lines == N_LINES[molecule]
    assert lines.formula == molecule
    nu = np.asarray(lines.nu)
    assert np.all(np.diff(nu) >= 0) and nu.min() > 0
    S = np.asarray(lines.S)
    assert S.min() > 0 and 8.0 <= np.log10(S.max() / S.min()) <= 11.0
    assert np.all((np.asarray(lines.ga) >= 0.05) & (np.asarray(lines.ga) <= 0.09))
    assert np.all((np.asarray(lines.gs) >= 0.07) & (np.asarray(lines.gs) <= 0.11))
    assert np.all((np.asarray(lines.na) >= 0.6) & (np.asarray(lines.na) <= 0.8))
    Epp = np.asarray(lines.Epp)
    assert Epp.min() >= 0.0 and Epp.max() <= 3000.0
    assert set(np.unique(np.asarray(lines.iso))) <= {1, 2, 3}


def test_co2_lines_sit_in_branches_of_the_bands():
    nu = np.asarray(synthetic_lines("CO2", seed=0).nu)
    # every line within a P/R branch reach (+-30 offset, band heads near
    # +60, P branches out to ~-150) of one of the five bands, all bands used
    d = np.abs(nu[:, None] - np.asarray(CO2_BANDS)[None, :])
    assert np.all(d.min(axis=1) < 200.0)
    assert np.all(np.bincount(d.argmin(axis=1), minlength=5) > 100)
    # branch spacing ~4B = 1.56 cm^-1 inside one sub-band
    par = synthetic_par("CO2", seed=0)
    gaps = np.diff(par["nu"][:40])
    assert 1.3 < np.median(np.abs(gaps)) < 1.7


def test_h2o_regions():
    nu = np.asarray(synthetic_lines("H2O", seed=0).nu)
    inside = ((nu <= 1000.0) | ((nu >= 1300.0) & (nu <= 2000.0))
              | ((nu >= 3400.0) & (nu <= 4000.0)))
    assert inside.all()
    assert (nu < 1000.0).sum() > (nu > 3400.0).sum()


def test_maxlines_keeps_the_strongest():
    full = synthetic_par("CO2", seed=0)
    top = synthetic_par("CO2", seed=0, maxlines=100)
    assert len(top["nu"]) == 100
    assert top["S"].min() >= np.sort(full["S"])[-100]


def test_block_count_quartiles_on_the_131072_point_grid():
    # the statistic the line-sum kernel's design rests on: most blocks see
    # few lines, a few see hundreds (see the module docstring)
    nu_l = np.asarray(synthetic_lines("CO2", seed=0).nu)
    grid = np.linspace(nu_l.min() - 25.0, nu_l.max() + 25.0, 131072)
    q = np.percentile(build_line_window_plan(grid, nu_l, 25.0).count,
                      [0, 25, 50, 75, 100])
    np.testing.assert_allclose(q, [0, 0, 0, 66.25, 952])


def test_unknown_molecule():
    with pytest.raises(ValueError, match="no synthetic catalog"):
        synthetic_par("O3")
