"""CIA inside the flux pipeline: pairing with gases, sigma summation, OLR effect.

The reference couples CIA continua to gas partial pressures through the CIA
struct (ref collision_induced_absorption.jl:431-465); these tests exercise
that full path against the bundled CO2-CO2 fixture.
"""

import os
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from clearsky_tpu.absorption.cia import read_cia, CIATables, cia_xsec, CIA
from clearsky_tpu.absorption.gas import DirectGas, GrayGas
from clearsky_tpu.absorption.absorbers import unify_absorbers
from clearsky_tpu.constants import R_GAS
from clearsky_tpu.rt.fluxes import outgoing
from clearsky_tpu.spectra.lines import SpectralLines
from clearsky_tpu.utils.grids import trapz


@pytest.fixture(scope="module")
def stack(fixtures_dir):
    lines = SpectralLines.from_par(f"{fixtures_dir}/CO2.par", maxlines=300)
    nu = np.linspace(1.0, 500.0, 256)  # CO2-CO2 CIA band region
    co2 = DirectGas.from_lines(lines, 0.95, nu)
    cia = CIATables.from_data(read_cia(f"{fixtures_dir}/CO2-CO2_2018.cia"))
    return co2, cia, nu


def test_stack_pairs_cia_with_gas(stack):
    co2, cia, nu = stack
    A = unify_absorbers((co2, cia))
    assert len(A.cias) == 1
    pair = A.cias[0]
    # both partners of CO2-CO2 resolve to the CO2 gas (stored as lightweight
    # formula+concentration component views, see CIA.pair)
    assert pair.g1.formula == "CO2" and pair.g2.formula == "CO2"
    assert pair.g1.fC is co2.fC and pair.g2.fC is co2.fC


def test_cia_increases_sigma_and_depth(stack):
    co2, cia, nu = stack
    A_gas = unify_absorbers((co2,))
    A_full = unify_absorbers((co2, cia))
    T = jnp.asarray([250.0])
    P = jnp.asarray([5e4])
    s_gas = np.asarray(A_gas.sigma(T, P))[0]
    s_full = np.asarray(A_full.sigma(T, P))[0]
    assert np.all(s_full >= s_gas - 1e-30)
    assert s_full.sum() > s_gas.sum()  # the continuum adds opacity somewhere


def test_cia_lowers_band_olr(stack):
    co2, cia, nu = stack
    fT = lambda P: jnp.maximum(280.0 * (jnp.asarray(P) / 1e5) ** (R_GAS / (0.044 * 850.0)), 150.0)
    fmu = lambda T, P: 0.044
    olr_gas = float(trapz(nu, outgoing(1e5, 9.8, fT, fmu, co2, Ptop=10.0, nlevels=64)))
    olr_full = float(
        trapz(nu, outgoing(1e5, 9.8, fT, fmu, co2, cia, Ptop=10.0, nlevels=64))
    )
    assert olr_full < olr_gas  # extra continuum opacity must reduce OLR
    assert olr_full > 0.2 * olr_gas  # and not absurdly so


def test_cia_xsec_amagat_conversion(stack):
    # scalar sanity: cross-section positive in the band, zero far outside
    _, cia, nu = stack
    bound = cia.bind(np.asarray(nu))
    k = bound.k(jnp.asarray(250.0))
    s = np.asarray(cia_xsec(k, 250.0, 5e4, 5e4, 5e4))
    assert s.shape == (len(np.asarray(nu)),)
    assert np.all(s >= 0.0) and s.max() > 0.0


def test_cia_sigma_finite_in_float32(fixtures_dir):
    """f32 regression: the amagat conversion must not touch Lo^2 = 7.2e38
    (overflows float32 max 3.4e38 -> inf -> NaN through the whole CIA path in
    float32, found driving configs 2-3 at production scale). The f64 suite cannot
    see this, so the test forces an f32 pytree."""
    import jax
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.absorption.gas import MultiGas
    from clearsky_tpu.absorption.cia import CIATables
    from clearsky_tpu.absorption.absorbers import unify_absorbers

    co2 = SpectralLines.from_par(f"{fixtures_dir}/CO2.par", maxlines=200)
    nu_l = np.asarray(co2.nu)
    nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, 128)
    mg = MultiGas.from_lines([(co2, 0.95)], nu)
    cia = CIATables.from_file(f"{fixtures_dir}/CO2-CO2_2018.cia")
    A = unify_absorbers((mg, cia))

    def to_f32(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(x, jnp.float32)
        return x

    # the conversion itself, with f32 inputs (python-float constants are
    # weakly typed, so the whole chain stays f32 — the old k*LOSCHMIDT_SQ
    # form casts 7.2e38 to f32 inf here and NaNs)
    from clearsky_tpu.absorption.cia import cia_xsec

    k = jnp.asarray([1e-44, 1e-40, 3e-38], jnp.float32)
    T32 = jnp.asarray(250.0, jnp.float32)
    Pa = jnp.asarray(1e5, jnp.float32)
    P1 = jnp.asarray(9.5e4, jnp.float32)
    sig32 = np.asarray(cia_xsec(k, T32, Pa, P1, P1))
    assert sig32.dtype == np.float32
    assert np.all(np.isfinite(sig32)), "cia_xsec overflowed in float32"
    sig64 = np.asarray(
        cia_xsec(k.astype(jnp.float64), 250.0, 1e5, 9.5e4, 9.5e4)
    )
    np.testing.assert_allclose(sig32, sig64, rtol=1e-5)

    # and the full f32-cast absorber stack must stay finite end to end
    A32 = jax.tree.map(to_f32, A)
    T = jnp.asarray([160.0, 250.0, 288.0], jnp.float32)
    P = jnp.asarray([1e2, 1e4, 1e5], jnp.float32)
    sig_stack = np.asarray(A32.sigma(T, P))
    assert np.all(np.isfinite(sig_stack))


def test_cia_survives_float32(fixtures_dir):
    """CIA absorption coefficients (~1e-44 cm^5/molecule^2) sit BELOW the
    float32 normal range: exp(log k) flushes to zero in f32 and the whole
    CIA contribution silently vanishes — found in round 4 as a missing
    24 W/m^2 of window-region downwelling that pushed the f32 config-4 RCE
    trajectory 16 K off the f64 oracle class (3 K). The production path now
    keeps the Loschmidt factor inside the exponential (k*Lo ~ 1e-25). The
    suite runs under x64, where f32 inputs silently promote, so the f32
    evaluation runs in a true-f32 subprocess.
    """
    import subprocess
    import sys

    worker = (
        "import jax; jax.config.update(\'jax_platforms\',\'cpu\')\n"
        "import numpy as np, jax.numpy as jnp, dataclasses\n"
        "from clearsky_tpu.absorption.cia import CIATables, CIA\n"
        "from clearsky_tpu.absorption.gas import GrayGas\n"
        f"tab = CIATables.from_file(\'{fixtures_dir}/CO2-CO2_2018.cia\')\n"
        "nu = np.linspace(1200.0, 1400.0, 64)\n"
        "g = dataclasses.replace(GrayGas.create(1e-30, nu), formula=\'CO2\')\n"
        "pair = CIA.pair(tab.bind(nu), (g,))\n"
        "s = np.asarray(pair.sigma(jnp.asarray(300.0), jnp.asarray(1e5)), np.float64)\n"
        "assert s.dtype == np.float64 and jnp.asarray(1.0).dtype == jnp.float32\n"
        "print(\'MAXSIG\', s.max())\n"
    )
    p = subprocess.run([sys.executable, "-c", worker], capture_output=True,
                       text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    s32 = float(p.stdout.split("MAXSIG")[1])

    tab = CIATables.from_file(f"{fixtures_dir}/CO2-CO2_2018.cia")
    nu = np.linspace(1200.0, 1400.0, 64)
    g = dataclasses.replace(GrayGas.create(1e-30, nu), formula="CO2")
    pair = CIA.pair(tab.bind(nu), (g,))
    s64 = float(np.asarray(pair.sigma(jnp.asarray(300.0), jnp.asarray(1e5)),
                           np.float64).max())
    assert s64 > 1e-26  # the band genuinely has CIA here
    assert abs(s32 - s64) / s64 < 1e-5, (s32, s64)
