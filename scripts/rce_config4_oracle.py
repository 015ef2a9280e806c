"""BASELINE config-4 north star: 1000-step RCE vs the adaptive oracle.

Scaled toward the reference's production regime
(ref radiative_convective.jl:108-171): full CO2 (5,599 lines) + H2O (3,058)
fused MultiGas + CO2-CO2 CIA, 20 levels, 1024 wavenumbers, radmul=2, with
BOTH user-loop cadences active (cross-section refresh every 20 steps,
convective adjustment every 5) in BOTH the production scanned loop and the
independent scipy-Radau oracle loop. Reports max|dT| over the whole
trajectory and the radmul-convergence of the initial heating profile.

Usage: python scripts/rce_config4_oracle.py [--steps 1000] [--nnu 1024]
Writes tests/golden/config4_oracle_1000step.npz (the frozen oracle that
tests/test_rce_oracle.py::test_rce_config4_500step_trajectory asserts
against) + prints one JSON report. Measured round 3: max|dT| 3.01 K over
1000 steps (2.03 K over the first 500), final 1.70 K, surface T agreement
0.08 K — the transients live in the convective-adjustment levels 14-18;
the purely radiative levels stay within 0.46 K (wall: 1967 s on 4 CPUs).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

PAR = "/root/reference/test/HITRAN"
G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
DT, UPDATE_EVERY, ADJUST_EVERY = 2e4, 20, 5


def build(radmul, nnu):
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.absorption.gas import MultiGas
    from clearsky_tpu.absorption.cia import CIATables
    from clearsky_tpu.constants import R_GAS
    from clearsky_tpu.models import rcm as rcm_mod
    from clearsky_tpu.utils.grids import pressuregrid

    co2 = SpectralLines.from_par(f"{PAR}/CO2.par")
    h2o = SpectralLines.from_par(f"{PAR}/H2O.par")
    nu_l = np.asarray(co2.nu)
    nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, nnu)
    mg = MultiGas.from_lines([(co2, 0.9), (h2o, 0.005)], nu)
    cia = CIATables.from_file(f"{PAR}/CO2-CO2_2018.cia")
    Pe = pressuregrid(PT, PS, 20)
    Te = np.maximum(285.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    return rcm_mod.RCM.create(
        Pe, Te, G, lambda T, P: MU, 0.0, 0.0, lambda T, P: CP, 1e7, mg, cia,
        radmul=radmul,
    )


def main():
    from clearsky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--nnu", type=int, default=1024)
    ap.add_argument("--rtol", type=float, default=1e-5)
    args = ap.parse_args()

    from clearsky_tpu.models import rcm as rcm_mod
    from clearsky_tpu.rt import ode_ref

    rep = {"steps": args.steps, "nnu": args.nnu, "rtol": args.rtol,
           "update_every": UPDATE_EVERY, "adjust_every": ADJUST_EVERY,
           "dt": DT}
    t0 = time.time()

    # heating-level agreement + radmul convergence (2 -> 4)
    errs = {}
    for radmul in (2, 4):
        r = build(radmul, args.nnu)
        H = np.asarray(rcm_mod.heating(r))
        O = ode_ref.ode_heating(r, rtol=args.rtol, atol=1e-8)
        scale = np.abs(O).max()
        errs[radmul] = float(np.abs(H - O).max() / scale)
        print(f"[{time.time()-t0:7.1f}s] radmul={radmul}: heating err "
              f"{errs[radmul]:.3e} of peak {scale:.3e} K/s", flush=True)
    rep["heating_err_radmul2"] = errs[2]
    rep["heating_err_radmul4"] = errs[4]
    rep["radmul_convergence_ratio"] = errs[4] / errs[2]

    # the trajectory north star
    r = build(2, args.nnu)
    out, recs = rcm_mod.run(
        r, DT, args.steps, update_every=UPDATE_EVERY,
        adjust_every=ADJUST_EVERY, cp=CP, mu=MU, record_every=1,
    )
    recs = np.asarray(recs)
    print(f"[{time.time()-t0:7.1f}s] production {args.steps}-step run done",
          flush=True)
    traj = ode_ref.ode_run(
        r, DT, args.steps, update_every=UPDATE_EVERY,
        adjust_every=ADJUST_EVERY, cp=CP, mu=MU, processes=4,
        rtol=args.rtol, atol=1e-8,
    )
    dT = np.abs(recs - traj)
    rep["max_abs_dT_K"] = float(dT.max())
    rep["final_max_abs_dT_K"] = float(dT[-1].max())
    rep["final_surface_T_prod"] = float(recs[-1, -1])
    rep["final_surface_T_oracle"] = float(traj[-1, -1])
    rep["wall_s"] = time.time() - t0
    np.savez(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tests", "golden", "config4_oracle_1000step.npz"),
        recs=recs, traj=traj, meta=json.dumps(rep),
    )
    print(json.dumps(rep, indent=1))


if __name__ == "__main__":
    main()
