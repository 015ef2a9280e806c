"""Sharding tests on the 8-device virtual CPU mesh.

Validates that the GSPMD and shard_map spectral-sharding paths reproduce the
single-device physics bit-for-bit (same arithmetic, one all-reduce), per the
multi-device test strategy in SURVEY.md §4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clearsky_tpu.absorption.gas import GrayGas
from clearsky_tpu.constants import R_GAS
from clearsky_tpu.models import rcm as rcm_mod
from clearsky_tpu.parallel import (
    spectral_mesh,
    trapz_weights,
    shard_spectral,
    sharded_radiate,
    make_sharded_heating,
    make_sharded_step,
)
from clearsky_tpu.utils.grids import pressuregrid, trapz

G, MU, CP, PS, PT = 9.8, 0.029, 1e3, 1e5, 10.0
N_NU = 512  # divisible by 8


def make_rcm(nnu=N_NU):
    nu = np.linspace(1.0, 3000.0, nnu)
    gas = GrayGas.create(5e-27, nu)
    Pe = pressuregrid(PT, PS, 16)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    return rcm_mod.RCM.create(
        Pe, Te, G, lambda T, P: MU, 0.0, 0.0, lambda T, P: CP, 1e7, gas
    )


def test_mesh_construction():
    m = spectral_mesh()
    assert m.shape["nu"] == 8 and m.shape["batch"] == 1
    m2 = spectral_mesh(n_batch=2)
    assert m2.shape["nu"] == 4 and m2.shape["batch"] == 2
    with pytest.raises(ValueError):
        spectral_mesh(n_nu_shards=3, n_batch=2)


def test_init_multihost_single_process_noop():
    # single process: a harmless no-op that reports rank 0 of 1 and leaves
    # mesh construction over the (virtual) local devices intact
    from clearsky_tpu.parallel import init_multihost

    idx, cnt = init_multihost()
    assert (idx, cnt) == (0, 1)
    assert spectral_mesh().shape["nu"] == 8


def test_trapz_weights_exact():
    nu = np.sort(np.random.default_rng(0).uniform(1.0, 100.0, 33))
    y = np.random.default_rng(1).normal(size=(4, 33))
    w = np.asarray(trapz_weights(nu))
    ref = np.asarray(trapz(jnp.asarray(nu), jnp.asarray(y)))
    np.testing.assert_allclose((y * w).sum(-1), ref, rtol=1e-14)


def test_sharded_radiate_matches_single_device():
    r = make_rcm()
    mesh = spectral_mesh()
    F_ref = rcm_mod.radiate_state(r)
    F_sh = sharded_radiate(mesh, r)
    np.testing.assert_allclose(
        np.asarray(F_sh.F_net), np.asarray(F_ref.F_net), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(F_sh.M_up), np.asarray(F_ref.M_up), rtol=1e-12
    )


def test_shard_map_heating_matches():
    r = make_rcm()
    mesh = spectral_mesh()
    H_ref = np.asarray(rcm_mod.heating(r))
    hfn = make_sharded_heating(mesh, r)
    H_sh = np.asarray(hfn(r.T))
    # psum reassociates the spectral reduction: bitwise equality is not
    # expected, only float64 reduction-order noise
    np.testing.assert_allclose(H_sh, H_ref, rtol=1e-9)


def test_shard_map_step_trajectory_matches():
    r = make_rcm()
    mesh = spectral_mesh()
    sfn = make_sharded_step(mesh, r, dt=300.0, update_every=2)
    T, A = r.T, sfn.rcm_sharded.A
    for i in range(4):
        T, A = sfn(T, A, i)
    # reference trajectory via the single-device run loop
    out, _ = rcm_mod.run(r, 300.0, 4, update_every=2)
    np.testing.assert_allclose(np.asarray(T), np.asarray(out.T), rtol=1e-9)


def _collective_counts(hlo_text):
    import re
    from collections import Counter

    ops = re.findall(
        r"\b(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
        r"(?:-start|-done)?\(",
        hlo_text,
    )
    return Counter(ops)


def test_sharded_step_compiles_to_one_collective():
    """The 'one psum per step' claim, checked against the compiled HLO.

    The design folds trapz into pointwise weights so the spectral integral is
    the ONLY cross-shard reduction (SURVEY.md §2.3); the cached cross-section
    refresh is per-wavenumber and must add no communication. This asserts the
    compiled program contains exactly one all-reduce and no other collective,
    on the flagship line-by-line path (DirectGas -> nu-sharded line slabs).
    """
    from clearsky_tpu.absorption.gas import DirectGas
    from clearsky_tpu.spectra.synthetic import synthetic_lines

    lines = synthetic_lines("CO2", seed=0, maxlines=200)
    nu_l = np.asarray(lines.nu)
    nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, 64)
    gas = DirectGas.from_lines(lines, 0.9, nu)
    Pe = pressuregrid(PT, PS, 8)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    r = rcm_mod.RCM.create(
        Pe, Te, G, lambda T, P: MU, 1e-3, 0.1, lambda T, P: CP, 1e7, gas
    )
    mesh = spectral_mesh(n_batch=2)

    sfn = make_sharded_step(mesh, r, dt=300.0, update_every=1)
    rs, ws = sfn.bound_args
    txt = sfn.jitted.lower(rs, ws, r.T, rs.A, jnp.asarray(0)).compile().as_text()
    counts = _collective_counts(txt)
    assert counts.get("all-reduce", 0) == 1, counts
    assert sum(counts.values()) == 1, counts

    hfn = make_sharded_heating(mesh, r)
    rs, ws = hfn.bound_args
    txt = hfn.jitted.lower(rs, ws, r.T, rs.A).compile().as_text()
    counts = _collective_counts(txt)
    assert counts.get("all-reduce", 0) == 1, counts
    assert sum(counts.values()) == 1, counts


def test_batched_columns_on_mesh():
    # data parallelism: vmapped heating over a batch of temperature columns,
    # batch axis on the mesh's 'batch' dimension
    r = make_rcm()
    mesh = spectral_mesh(n_batch=2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    Tb = jnp.stack([r.T, r.T * 1.01, r.T * 0.99, r.T * 1.02])
    r_s = shard_spectral(r, mesh, N_NU)
    Tb_s = jax.device_put(Tb, NamedSharding(mesh, P("batch", None)))
    Hb = jax.jit(jax.vmap(lambda t: rcm_mod.heating(r_s, t)))(Tb_s)
    H0 = rcm_mod.heating(r, Tb[1])
    np.testing.assert_allclose(
        np.asarray(Hb[1]), np.asarray(H0), rtol=1e-9
    )


def test_gspmd_radiate_gathers_no_spectrum():
    """The GSPMD-sharded radiate program keeps every per-wavenumber operand
    shard-local: no all-gather or all-to-all of the spectrum (the scan march
    and the line sum are per-wavenumber, only the integral reduces)."""
    r = make_rcm()
    mesh = spectral_mesh()
    r_s = shard_spectral(r, mesh, N_NU)
    txt = jax.jit(rcm_mod.radiate_state).lower(r_s).compile().as_text()
    counts = _collective_counts(txt)
    assert counts.get("all-gather", 0) == 0, counts
    assert counts.get("all-to-all", 0) == 0, counts
