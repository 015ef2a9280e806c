"""Smoke run of the main path on an NVIDIA GPU, checked against float64.

    python chip_smoke.py             # one card: phases (a)-(d)
    python chip_smoke.py --cards 4   # four cards: the sharded RCE step only

Everything runs through the public API on the seeded synthetic CO2 and H2O
catalogs (``clearsky_tpu.spectra.synthetic``); nothing is read from disk.
Each reference is the plain ``jax.numpy`` path in float64, on the card, with
x64 scoped to that computation (float64 line sums take the plain path, see
``clearsky_tpu.backend``).

One card:
  (a) line sum: the selected implementation vs the float64 plain path,
      16 states on 2^19 points, voigt (cut 25) and phco2 (cut 500);
  (b) direct-mode OLR (``DirectGas`` + ``outgoing``): 2^19 points,
      20 levels, 5 streams; plus a transparent column against sigma T^4;
  (c) table mode: device bake (``Gas.from_lines``) on a 12 T x 24 P
      domain, table OLR against (b), and ln(sigma) of the table contraction
      at Precision.HIGH and HIGHEST against a float64 contraction;
  (d) RCM: synthetic CO2 + H2O ``MultiGas`` on 16,384 points, 20 levels,
      ``run`` for 32 steps (dt 2e4 s, cross sections refreshed every step).

Four cards (``--cards 4``): the ``shard_map`` RCE step on a 1x4
('batch', 'nu') mesh and the GSPMD batched step (8 columns) on a 2x2 mesh,
both on the synthetic CO2 catalog at 2^19 points and 20 levels, each
against the unsharded one-card step; the compiled sharded heating must hold
exactly one all-reduce.

Each phase prints one line with its numbers and tolerance; compile and run
times are printed apart (runs: median of warm calls ended by
``block_until_ready``). A failed check raises, and the script exits nonzero.
The first line is the card's name and power limit; the last line is one
JSON object naming the device.
"""

import argparse
import dataclasses
import json
import re
import statistics
import sys
import time

import numpy as np

N_NU = 2**19
N_STATES = 16
N_LEVELS = 20
G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0


def _timed(fn, *args, reps=5):
    """(compile_s, median_run_s, output) of jax.jit(fn)(*args)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return t_compile, statistics.median(runs), out


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _f64():
    import jax

    return jax.enable_x64(True)


def _grid(lines, n_nu):
    nu_l = np.asarray(lines.nu, np.float64)
    return np.linspace(nu_l.min() - 25.0, nu_l.max() + 25.0, n_nu)


def _column(n_levels):
    from clearsky_tpu.constants import R_GAS
    from clearsky_tpu.utils.grids import pressuregrid

    Pe = pressuregrid(PT, PS, n_levels)
    Te = np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    return Pe, Te


def phase_linesum(par, n_nu=N_NU, n_states=N_STATES):
    """(a) the selected line sum vs the float64 plain path."""
    import jax.numpy as jnp
    from clearsky_tpu.backend import linesum_impl
    from clearsky_tpu.ops.linesum import (
        build_line_window_plan, sigma_from_lines, sigma_from_lines_auto)
    from clearsky_tpu.spectra.lines import SpectralLines

    lines = SpectralLines.from_par_dict(par)
    nu = _grid(lines, n_nu)
    T = np.linspace(180.0, 320.0, n_states)
    P = np.exp(np.linspace(np.log(10.0), np.log(1e5), n_states))
    for shape, cut in (("voigt", 25.0), ("phco2", 500.0)):
        plan = build_line_window_plan(nu, np.asarray(lines.nu), cut)
        Pj = jnp.asarray(P, jnp.float32)
        c, t, sig = _timed(
            lambda T: sigma_from_lines_auto(plan, lines, T, Pj, 0.95 * Pj, shape),
            jnp.asarray(T, jnp.float32))
        with _f64():
            lines64 = SpectralLines.from_par_dict(par)
            P64 = jnp.asarray(P)
            c64, t64, ref = _timed(
                lambda T: sigma_from_lines(plan, lines64, T, P64, 0.95 * P64, shape),
                jnp.asarray(T), reps=1)
        sig, ref = np.asarray(sig, np.float64), np.asarray(ref)
        m = ref >= 1e-8 * ref.max(axis=-1, keepdims=True)
        rel = float((np.abs(sig - ref)[m] / ref[m]).max())
        print(f"(a) line sum {shape} cut {cut:g}: {linesum_impl()} "
              f"compile {c:.2f} s run {t * 1e3:.3f} ms | f64 plain compile "
              f"{c64:.2f} s run {t64 * 1e3:.3f} ms | {n_states} states x "
              f"{n_nu} pts, max rel {rel:.3e} (tol 1e-4 where sigma >= 1e-8 "
              f"x column max)", flush=True)
        _check(np.all(np.isfinite(sig)) and sig.shape == ref.shape,
               "line sum: non-finite or misshapen output")
        _check(rel <= 1e-4, f"line sum {shape}: max rel {rel:.3e} > 1e-4")


def _olr_fn(Pe, gas):
    """OLR spectrum and band OLR through the public API (``outgoing`` checks
    the absorber on the host, so the gas is closed over, not traced)."""
    from clearsky_tpu.rt.fluxes import outgoing
    from clearsky_tpu.utils.grids import trapz

    def f(T):
        M = outgoing(Pe, G, T, lambda T, P: MU, gas, nstream=5, nlobatto=3)
        return M, trapz(gas.nu, M)

    return f


def phase_direct_olr(par, n_nu=N_NU, n_levels=N_LEVELS):
    """(b) direct-mode OLR vs float64, and a transparent column."""
    import jax.numpy as jnp
    from clearsky_tpu import DirectGas, GrayGas, SIGMA_SB
    from clearsky_tpu.spectra.lines import SpectralLines

    lines = SpectralLines.from_par_dict(par)
    nu = _grid(lines, n_nu)
    Pe, Te = _column(n_levels)
    gas = DirectGas.from_lines(lines, 0.95, nu)
    c, t, (M, band) = _timed(_olr_fn(Pe, gas), jnp.asarray(Te, jnp.float32))
    with _f64():
        gas64 = DirectGas.from_lines(SpectralLines.from_par_dict(par), 0.95, nu)
        c64, t64, (M64, band64) = _timed(_olr_fn(Pe, gas64), jnp.asarray(Te),
                                         reps=1)
    M, M64 = np.asarray(M, np.float64), np.asarray(M64)
    band, band64 = float(band), float(band64)
    rel = abs(band - band64) / band64
    dM = float(np.abs(M - M64).max() / np.abs(M64).max())
    print(f"(b) direct OLR {n_nu} pts x {n_levels} levels: compile {c:.2f} s "
          f"run {t * 1e3:.3f} ms | f64 compile {c64:.2f} s run "
          f"{t64 * 1e3:.3f} ms | band {band:.6f} vs {band64:.6f} W/m^2, rel "
          f"{rel:.3e} (tol 1e-4), max |dM_up| {dM:.3e} of peak (tol 1e-3)",
          flush=True)
    _check(np.all(np.isfinite(M)) and M.shape == (n_nu,), "OLR: bad output")
    _check(rel <= 1e-4, f"direct band OLR rel {rel:.3e} > 1e-4")
    _check(dM <= 1e-3, f"direct OLR spectrum {dM:.3e} of peak > 1e-3")

    wide = np.linspace(1.0, 1e4, n_nu)
    clear = GrayGas.create(0.0, wide)
    _, t_clear, (_, band_clear) = _timed(
        _olr_fn(Pe, clear), jnp.full(Pe.shape, 290.0, jnp.float32))
    sb = SIGMA_SB * 290.0**4
    rel_sb = abs(float(band_clear) - sb) / sb
    print(f"(b) transparent column Ts 290 K: OLR {float(band_clear):.4f} vs "
          f"sigma T^4 {sb:.4f} W/m^2, rel {rel_sb:.3e} (tol 1e-4), run "
          f"{t_clear * 1e3:.3f} ms", flush=True)
    _check(rel_sb <= 1e-4, f"transparent OLR rel {rel_sb:.3e} > 1e-4")
    return band64


def phase_table(par, band64, n_nu=N_NU, n_levels=N_LEVELS):
    """(c) device bake, table OLR vs (b), and the contraction's precision."""
    import jax
    import jax.numpy as jnp
    from clearsky_tpu import AtmosphericDomain, Gas
    from clearsky_tpu.rt.discretized import lobatto_pressures
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.utils.interp import cheb_basis, interp_linear

    lines = SpectralLines.from_par_dict(par)
    nu = _grid(lines, n_nu)
    Pe, Te = _column(n_levels)
    dom = AtmosphericDomain.create((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
    t0 = time.perf_counter()
    gas = Gas.from_lines(lines, 0.95, nu, dom)
    jax.block_until_ready(gas.coeffs)
    t_bake = time.perf_counter() - t0
    c, t, (M, band) = _timed(_olr_fn(Pe, gas), jnp.asarray(Te, jnp.float32))
    rel = abs(float(band) - band64) / band64
    print(f"(c) table bake 12 T x 24 P x {n_nu} pts: {t_bake:.2f} s with "
          f"compile | table OLR compile {c:.2f} s run {t * 1e3:.3f} ms | band "
          f"{float(band):.6f} vs direct f64 {band64:.6f} W/m^2, rel {rel:.3e} "
          f"(tol 1e-2)", flush=True)
    _check(np.all(np.isfinite(np.asarray(M))), "table OLR: non-finite")
    _check(rel <= 1e-2, f"table band OLR rel {rel:.3e} > 1e-2")

    # ln(sigma) at the column's Lobatto nodes: the table contraction at
    # HIGH and HIGHEST against float64 with the same coefficients
    Pn = np.asarray(lobatto_pressures(jnp.asarray(Pe), 3)).reshape(-1)
    Tn = np.asarray(interp_linear(jnp.log(jnp.asarray(Pn)),
                                  jnp.log(jnp.asarray(Pe)), jnp.asarray(Te)))
    BT = cheb_basis(jnp.asarray(Tn), dom.Tmin, dom.Tmax, dom.nT)
    BP = cheb_basis(jnp.log(jnp.asarray(Pn)), np.log(dom.Pmin), np.log(dom.Pmax), dom.nP)
    basis = (BT[:, :, None] * BP[:, None, :]).reshape(len(Pn), -1).astype(jnp.float32)
    hi = jax.lax.Precision
    ln = {p: np.asarray(jax.jit(lambda b, c, p=p: jnp.matmul(b, c, precision=p))(
        basis, gas.coeffs)) for p in (hi.HIGH, hi.HIGHEST)}
    with _f64():
        ln64 = np.asarray(jnp.matmul(jnp.asarray(basis, jnp.float64),
                                     jnp.asarray(gas.coeffs, jnp.float64),
                                     precision=hi.HIGHEST))
    err = {p: float(np.abs(ln[p] - ln64).max()) for p in ln}
    print(f"(c) table ln(sigma) vs f64 contraction at {len(Pn)} states: "
          f"max |d ln sigma| HIGH {err[hi.HIGH]:.3e}, HIGHEST "
          f"{err[hi.HIGHEST]:.3e} (tol 1e-3 at HIGHEST)", flush=True)
    _check(err[hi.HIGHEST] <= 1e-3,
           f"HIGHEST ln sigma error {err[hi.HIGHEST]:.3e} > 1e-3")


def _rcm(par_co2, par_h2o, n_nu, n_levels):
    import jax.numpy as jnp
    from clearsky_tpu import MultiGas, RCM
    from clearsky_tpu.constants import R_GAS
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.utils.grids import pressuregrid

    mu, cp = 0.029, 1e3
    nu = np.linspace(100.0, 2200.0, n_nu)
    mix = MultiGas.from_lines(
        [(SpectralLines.from_par_dict(par_co2), 400e-6),
         (SpectralLines.from_par_dict(par_h2o), 0.01)], nu)
    Pe = pressuregrid(50.0, PS, n_levels)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (mu * cp)), 180.0)
    fS = lambda v: jnp.full(jnp.shape(v), 240.0 / (nu[-1] - nu[0]))
    return RCM.create(Pe, Te, G, lambda T, P: mu, fS, 0.0, lambda T, P: cp,
                      5e5, mix)


def phase_rcm(par_co2, par_h2o, n_nu=16384, n_levels=N_LEVELS, nsteps=32):
    """(d) RCM heating and a 32-step run with per-step refresh vs float64."""
    from clearsky_tpu import heating, run

    def steps(r):
        def f(T):
            out, _ = run(dataclasses.replace(r, T=T), dt=2e4, nsteps=nsteps,
                         update_every=1)
            return heating(r, r.T), out.T
        return f

    r = _rcm(par_co2, par_h2o, n_nu, n_levels)
    c, t, (H, T) = _timed(steps(r), r.T, reps=3)
    with _f64():
        r64 = _rcm(par_co2, par_h2o, n_nu, n_levels)
        c64, t64, (H64, T64) = _timed(steps(r64), r64.T, reps=1)
    H, T, H64, T64 = (np.asarray(x, np.float64) for x in (H, T, H64, T64))
    dH = float(np.abs(H - H64).max() / np.abs(H64).max())
    dT = float(np.abs(T - T64).max())
    print(f"(d) RCM CO2+H2O {n_nu} pts x {n_levels} levels, {nsteps} steps: "
          f"compile {c:.2f} s run {t * 1e3:.3f} ms ({t / nsteps * 1e3:.3f} "
          f"ms/step) | f64 compile {c64:.2f} s run {t64 * 1e3:.3f} ms | "
          f"step-0 heating max diff {dH:.3e} of peak (tol 1e-2), T after "
          f"{nsteps} steps max diff {dT:.3e} K (tol 0.1)", flush=True)
    _check(np.all(np.isfinite(T)) and np.all(np.isfinite(H)), "RCM: non-finite")
    _check(dH <= 1e-2, f"step-0 heating {dH:.3e} of peak > 1e-2")
    _check(dT <= 0.1, f"T after {nsteps} steps off by {dT:.3e} K > 0.1")


def _collectives(hlo: str) -> dict:
    """Collective ops in compiled HLO text (async pairs counted once)."""
    ops = re.findall(r"\b(all-reduce|all-gather|reduce-scatter|"
                     r"collective-permute|all-to-all)(?:-start)?\(", hlo)
    return {k: ops.count(k) for k in set(ops)}


def phase_four_cards(par, n_nu=N_NU, n_levels=N_LEVELS, n_cols=8):
    """The sharded RCE step on four cards vs the unsharded one-card step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from clearsky_tpu import DirectGas, RCM, heating
    from clearsky_tpu.parallel import (
        make_sharded_heating, make_sharded_step, shard_lbl, shard_spectral,
        spectral_mesh)
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.utils.interp import interp_linear

    devices = jax.devices()
    _check(len(devices) == 4, f"--cards 4 needs 4 devices, found {len(devices)}")
    lines = SpectralLines.from_par_dict(par)
    nu = _grid(lines, n_nu)
    Pe, Te = _column(n_levels)
    gas = DirectGas.from_lines(lines, 0.95, nu)
    r = RCM.create(Pe, Te, G, lambda T, P: MU, 1e-3, 0.1, lambda T, P: CP,
                   1e7, gas)
    dt = 300.0
    lnPe, lnP = jnp.log(r.Pe), jnp.log(r.P)

    def one_card_step(T, rr):
        T1 = T + dt * heating(rr, T)
        return T1, rr.A.update(interp_linear(lnPe, lnP, T1))

    _, t_ref, (T1_ref, A1_ref) = _timed(one_card_step, r.T, r)
    T1_ref, ln_ref = np.asarray(T1_ref), np.asarray(A1_ref.ln_sigma)

    mesh = spectral_mesh(n_batch=1, devices=devices)
    step = make_sharded_step(mesh, r, dt=dt, update_every=1)
    rs, ws = step.bound_args
    _, t_sm, (T1, A1) = _timed(lambda T, A: step.jitted(rs, ws, T, A, jnp.asarray(0)),
                               r.T, rs.A)
    err_T = float(np.abs(np.asarray(T1) - T1_ref).max() / np.abs(T1_ref).max())
    err_A = float(np.abs(np.asarray(A1.ln_sigma) - ln_ref).max()
                  / np.abs(ln_ref).max())
    hfn = make_sharded_heating(mesh, r)
    hs, hw = hfn.bound_args
    coll = _collectives(hfn.jitted.lower(hs, hw, r.T, hs.A).compile().as_text())
    print(f"(4 cards) shard_map step mesh {dict(mesh.shape)}, {n_nu} pts x "
          f"{n_levels} levels: run {t_sm * 1e3:.3f} ms vs one card "
          f"{t_ref * 1e3:.3f} ms | T max rel {err_T:.3e}, refreshed ln sigma "
          f"max rel {err_A:.3e} (tol 1e-5) | sharded heating collectives "
          f"{coll} (want exactly one all-reduce)", flush=True)
    _check(err_T <= 1e-5 and err_A <= 1e-5, "shard_map step diverges")
    _check(coll == {"all-reduce": 1}, f"sharded heating collectives {coll}")

    mesh2 = spectral_mesh(n_batch=2, devices=devices)
    Tb = jnp.stack([r.T * (1.0 + 0.01 * i) for i in range(n_cols)])
    r_s = shard_spectral(shard_lbl(r, mesh2.shape["nu"]), mesh2, n_nu)
    Tb_s = jax.device_put(Tb, NamedSharding(mesh2, P("batch", None)))
    batched = lambda Tb, rr: Tb + dt * jax.vmap(lambda t: heating(rr, t))(Tb)
    _, t_gs, Tb1 = _timed(batched, Tb_s, r_s)
    _, t_b1, Tb1_ref = _timed(batched, Tb, r)
    Tb1, Tb1_ref = np.asarray(Tb1), np.asarray(Tb1_ref)
    err_b = float(np.abs(Tb1 - Tb1_ref).max() / np.abs(Tb1_ref).max())
    print(f"(4 cards) GSPMD batched step mesh {dict(mesh2.shape)}, {n_cols} "
          f"columns: run {t_gs * 1e3:.3f} ms vs one card {t_b1 * 1e3:.3f} ms "
          f"| max rel {err_b:.3e} (tol 1e-5)", flush=True)
    _check(err_b <= 1e-5, f"GSPMD batched step diverges: {err_b:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found platform {dev.platform!r}")
    from clearsky_tpu.spectra.synthetic import synthetic_par
    from clearsky_tpu.utils.compile_cache import enable_compile_cache
    from clearsky_tpu.utils.profiling import card_name_and_power_limit

    print(card_name_and_power_limit(), flush=True)
    enable_compile_cache()
    co2 = synthetic_par("CO2", seed=0)
    if args.cards == 4:
        phase_four_cards(co2)
    else:
        phase_linesum(co2)
        band64 = phase_direct_olr(co2)
        phase_table(co2, band64)
        phase_rcm(co2, synthetic_par("H2O", seed=0))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
