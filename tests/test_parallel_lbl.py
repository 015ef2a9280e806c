"""nu-sharded line-by-line opacity on the 8-device virtual CPU mesh.

The reference's parallel axis exists to scale *real-gas* (line-by-line) work —
threads over wavenumber with the moving line window (ClearSky.jl
``fluxes.jl:270``, ``line_shapes.jl:10-22``). These tests prove the device
equivalent: per-shard line slabs with cut-width halos (``absorption.sharded``)
reproduce the single-device DirectGas/MultiGas/CIA physics under both
``shard_map`` and GSPMD to reduction-order tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clearsky_tpu.spectra.synthetic import synthetic_lines
from clearsky_tpu.absorption.gas import DirectGas, MultiGas
from clearsky_tpu.absorption.cia import CIATables
from clearsky_tpu.absorption.sharded import ShardedLineGas, shard_line_gas
from clearsky_tpu.constants import R_GAS
from clearsky_tpu.models import rcm as rcm_mod
from clearsky_tpu.parallel import (
    spectral_mesh,
    shard_lbl,
    shard_spectral,
    sharded_radiate,
    make_sharded_heating,
    make_sharded_step,
)
from clearsky_tpu.utils.grids import pressuregrid

G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
N_NU = 512


@pytest.fixture(scope="module")
def co2_lines():
    return synthetic_lines("CO2", seed=0, maxlines=300)


@pytest.fixture(scope="module")
def h2o_lines():
    return synthetic_lines("H2O", seed=0, maxlines=200)


def _grid(lines, n=N_NU):
    nu_l = np.asarray(lines.nu)
    return np.linspace(nu_l.min() - 25.0, nu_l.max() + 25.0, n)


def _rcm(*absorbers, n_levels=12):
    Pe = pressuregrid(PT, PS, n_levels)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    return rcm_mod.RCM.create(
        Pe, Te, G, lambda T, P: MU, 0.0, 0.0, lambda T, P: CP, 1e7, *absorbers
    )


def test_sharded_gas_matches_direct(co2_lines):
    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    sg = shard_line_gas(gas, 8)
    T = jnp.asarray([210.0, 260.0, 310.0])
    P = jnp.asarray([1e2, 1e4, 9e4])
    ref = np.asarray(gas.raw_sigma(T, P))
    got = np.asarray(sg.raw_sigma(T, P))
    # same lines in every window; only the banding (summation order) differs
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=ref.max() * 1e-15)


def test_sharded_gas_lineless_shards(co2_lines):
    # grid extending far beyond the catalog on BOTH ends: the bottom and top
    # shards contain no lines at all (a == b == 0 / == n_lines in the slab
    # search) — regression for the b = max(b, a+1) clamp running before the
    # a = min(a, n-1) clamp, which indexed past the catalog
    nu_l = np.asarray(co2_lines.nu)
    span = nu_l.max() - nu_l.min()
    nu = np.linspace(max(nu_l.min() - 2 * span, 1.0), nu_l.max() + 2 * span, N_NU)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    sg = shard_line_gas(gas, 8)
    T = jnp.asarray([220.0, 300.0])
    P = jnp.asarray([1e3, 5e4])
    ref = np.asarray(gas.raw_sigma(T, P))
    got = np.asarray(sg.raw_sigma(T, P))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=ref.max() * 1e-15)


def test_sharded_plan_keeps_float64_grid(co2_lines):
    # shard_line_gas must rebuild per-shard plans from the PLAN's float64
    # grid, not from gas.nu — which is float32 whenever x64 is off (as on
    # the GPU). Regression: with an f32 gas.nu the two-float block positions
    # (hi + lo) previously reconstructed the f32-ROUNDED grid (lo ~ 0,
    # ~5e-4 cm^-1 position error at 1e4 cm^-1), flipping line membership at
    # the cut boundary and biasing deep-wing sigma by O(10%).
    import dataclasses as dc

    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    gas32 = dc.replace(gas, nu=jnp.asarray(gas.nu, jnp.float32))  # x64 off
    sg = shard_line_gas(gas32, 8)
    # in the f64 suite the stacked nu_blocks hold the full-precision source
    # grid the two-float (hi, lo) pair is derived from — it must be the
    # constructor's f64 grid, not a round trip through the f32 gas.nu
    got = np.asarray(sg.plans.nu_blocks, np.float64).reshape(-1)[: len(nu)]
    exact = np.asarray(gas.plan.nu_blocks).reshape(-1)[: len(nu)]
    np.testing.assert_array_equal(got, exact)


def test_sharded_multigas_matches(co2_lines, h2o_lines):
    nu = _grid(co2_lines)
    mg = MultiGas.from_lines([(co2_lines, 0.3), (h2o_lines, 0.01)], nu)
    sg = shard_line_gas(mg, 8)
    T = jnp.asarray([230.0, 290.0])
    P = jnp.asarray([5e3, 7e4])
    ref = np.asarray(mg.raw_sigma(T, P))
    got = np.asarray(sg.raw_sigma(T, P))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=ref.max() * 1e-15)


def test_shard_line_gas_validation(co2_lines):
    nu = _grid(co2_lines, 510)  # not divisible by 8
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    with pytest.raises(ValueError):
        shard_line_gas(gas, 8)
    gas512 = DirectGas.from_lines(co2_lines, 0.9, _grid(co2_lines))
    sg = shard_line_gas(gas512, 8)
    assert shard_line_gas(sg, 8) is sg
    with pytest.raises(ValueError):
        shard_line_gas(sg, 4)


def test_shard_map_heating_directgas_cia(co2_lines, fixtures_dir):
    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    cia = CIATables.from_file(f"{fixtures_dir}/CO2-CO2_2018.cia")
    r = _rcm(gas, cia)
    H_ref = np.asarray(rcm_mod.heating(r))
    mesh = spectral_mesh()
    hfn = make_sharded_heating(mesh, r)
    H_sh = np.asarray(hfn(r.T))
    np.testing.assert_allclose(H_sh, H_ref, rtol=1e-9)


def test_shard_map_step_trajectory_multigas(co2_lines, h2o_lines):
    nu = _grid(co2_lines)
    mg = MultiGas.from_lines([(co2_lines, 0.9), (h2o_lines, 0.005)], nu)
    r = _rcm(mg)
    mesh = spectral_mesh()
    sfn = make_sharded_step(mesh, r, dt=300.0, update_every=2)
    T, A = r.T, sfn.rcm_sharded.A
    for i in range(4):
        T, A = sfn(T, A, i)
    out, _ = rcm_mod.run(r, 300.0, 4, update_every=2)
    np.testing.assert_allclose(np.asarray(T), np.asarray(out.T), rtol=1e-9)


def test_gspmd_radiate_and_update_directgas(co2_lines):
    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    r = _rcm(gas)
    mesh = spectral_mesh()
    F_ref = rcm_mod.radiate_state(r)
    F_sh = sharded_radiate(mesh, r)
    np.testing.assert_allclose(
        np.asarray(F_sh.F_net), np.asarray(F_ref.F_net), rtol=1e-12
    )
    # the absorber update is the path that actually evaluates the line sum
    r_s = shard_spectral(shard_lbl(r, 8), mesh, N_NU)
    Te2 = jnp.linspace(160.0, 290.0, r.Pe.shape[0])
    A_ref = r.A.update(Te2)
    A_sh = jax.jit(lambda a, t: a.update(t))(r_s.A, Te2)
    np.testing.assert_allclose(
        np.asarray(A_sh.ln_sigma), np.asarray(A_ref.ln_sigma), rtol=1e-10, atol=1e-12
    )


def test_sharded_gas_in_batched_columns(co2_lines):
    # 2-D ('batch', 'nu') placement with the line-by-line absorber
    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    r = _rcm(gas)
    mesh = spectral_mesh(n_batch=2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    Tb = jnp.stack([r.T, r.T * 1.01, r.T * 0.99, r.T * 1.02])
    r_s = shard_spectral(shard_lbl(r, mesh.shape["nu"]), mesh, N_NU)
    Tb_s = jax.device_put(Tb, NamedSharding(mesh, P("batch", None)))
    Hb = jax.jit(jax.vmap(lambda t: rcm_mod.heating(r_s, t)))(Tb_s)
    H0 = rcm_mod.heating(r, Tb[1])
    np.testing.assert_allclose(np.asarray(Hb[1]), np.asarray(H0), rtol=1e-9)


def test_sharded_gas_is_differentiable(co2_lines):
    """jacfwd through a sharded line-by-line gas must match the unsharded
    gas (on the GPU this exercises the device-plan custom JVP; on CPU the
    plain path — either way the sharded path must be differentiable)."""
    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    sg = shard_line_gas(gas, 4)
    T = jnp.asarray([230.0, 300.0])
    P = jnp.asarray([5e3, 6e4])
    f_ref = lambda t: gas.raw_sigma(t, P).sum(axis=-1).sum()
    f_sh = lambda t: sg.raw_sigma(t, P).sum(axis=-1).sum()
    J_ref = np.asarray(jax.jacfwd(f_ref)(T))
    J_sh = np.asarray(jax.jacfwd(f_sh)(T))
    np.testing.assert_allclose(J_sh, J_ref, rtol=1e-10)


def test_sharded_heating_jacobian_matches(co2_lines):
    """jacfwd through the GSPMD-sharded heating (including the absorber
    refresh) must match the single-device Jacobian — the multichip
    equivalent of jacobian(update_sigma=True)."""
    import dataclasses as dc

    nu = _grid(co2_lines)
    gas = DirectGas.from_lines(co2_lines, 0.9, nu)
    r = _rcm(gas, n_levels=8)
    mesh = spectral_mesh()
    r_s = shard_spectral(shard_lbl(r, mesh.shape["nu"]), mesh, N_NU)
    lnPe, lnP = jnp.log(r.Pe), jnp.log(r.P)

    def H_of_T(rr):
        def f(T):
            A = rr.A.update(interp_linear(lnPe, lnP, T))
            return rcm_mod.heating(rr, T, A)
        return f

    from clearsky_tpu.utils.interp import interp_linear

    J_ref = np.asarray(jax.jacfwd(H_of_T(r))(r.T))
    J_sh = np.asarray(jax.jit(jax.jacfwd(H_of_T(r_s)))(r_s.T))
    scale = np.abs(J_ref).max()
    np.testing.assert_allclose(J_sh, J_ref, rtol=1e-8, atol=scale * 1e-10)


def test_baked_table_gas_under_mesh(co2_lines, fixtures_dir):
    """Table-mode Gas (+BoundCIA) under shard_map and GSPMD vs single device,
    including an AcceleratedAbsorber.update refresh over the sharded table.

    The baked table's coeffs are [nT*nP, n_nu] (ref gases.jl:205-213), so the
    trailing-axis rule shards them over 'nu'; nothing converts (shard_lbl is a
    no-op for table gases) and the physics must be reduction-order identical.
    """
    from clearsky_tpu.absorption.domain import AtmosphericDomain
    from clearsky_tpu.absorption.gas import Gas

    nu = _grid(co2_lines, n=256)
    dom = AtmosphericDomain.create((150.0, 350.0), 8, (PT, PS), 12)
    gas = Gas.from_lines(co2_lines, 0.9, nu, dom)
    cia = CIATables.from_file(f"{fixtures_dir}/CO2-CO2_2018.cia")
    r = _rcm(gas, cia)
    mesh = spectral_mesh()

    # GSPMD radiate
    F_ref = rcm_mod.radiate_state(r)
    F_sh = sharded_radiate(mesh, r)
    np.testing.assert_allclose(
        np.asarray(F_sh.F_net), np.asarray(F_ref.F_net), rtol=1e-12
    )

    # shard_map heating
    H_ref = np.asarray(rcm_mod.heating(r))
    hfn = make_sharded_heating(mesh, r)
    np.testing.assert_allclose(
        np.asarray(hfn(r.T)), H_ref, rtol=1e-9,
        atol=1e-9 * np.abs(H_ref).max(),
    )

    # AcceleratedAbsorber.update over the sharded table (the refresh path
    # evaluates the Chebyshev contraction against sharded coeffs)
    r_s = shard_spectral(r, mesh, 256)
    Te2 = jnp.linspace(160.0, 290.0, r.Pe.shape[0])
    A_ref = r.A.update(Te2)
    A_sh = jax.jit(lambda a, t: a.update(t))(r_s.A, Te2)
    np.testing.assert_allclose(
        np.asarray(A_sh.ln_sigma), np.asarray(A_ref.ln_sigma),
        rtol=1e-10, atol=1e-12,
    )

    # full sharded step trajectory with refresh cadence
    sfn = make_sharded_step(mesh, r, dt=300.0, update_every=2)
    T, A = r.T, sfn.rcm_sharded.A
    for i in range(4):
        T, A = sfn(T, A, i)
    out, _ = rcm_mod.run(r, 300.0, 4, update_every=2)
    np.testing.assert_allclose(np.asarray(T), np.asarray(out.T), rtol=1e-9)
