"""Scaling report: sharded RCE heating across virtual device counts.

Measures the shard_map heating program on 1..N virtual CPU devices to
demonstrate the spectral-sharding mechanism (BASELINE north-star metric #2 is
defined on real multi-chip hardware; virtual CPU devices share host cores, so
the numbers here validate the mechanism and the collective structure, not
absolute scaling efficiency).

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/scaling_report.py
"""

import os
import sys
import time

sys.path.insert(0, ".")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
# float64 for the cross-shard-count consistency check: in float32 the
# top-of-atmosphere heating (a small difference of large fluxes) amplifies
# rounding noise to percent level, masking any real sharding error
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp


CO2_PAR = "/root/reference/test/HITRAN/CO2.par"


def _bench_column(name, r, make_sharded_heating, spectral_mesh, devices):
    print(f"== {name} ==")
    H_ref = None
    base = None
    for k in [1, 2, 4, 8]:
        if k > len(devices):
            break
        mesh = spectral_mesh(n_nu_shards=k, devices=devices[:k])
        hfn = make_sharded_heating(mesh, r)
        H = np.asarray(hfn(r.T))  # compile
        if H_ref is None:
            H_ref = H
        else:
            np.testing.assert_allclose(H, H_ref, rtol=1e-9)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = hfn(r.T)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        if base is None:
            base = dt
        print(
            f"  nu-shards={k}: {dt*1e3:7.2f} ms/heating  "
            f"speedup {base/dt:4.2f}x  (physics identical to 1e-9)"
        )


def weak_scaling_arithmetic(n_nu=524288, n_shards=8, maxlines=None):
    """The arithmetic behind the >=80% weak-scaling north-star claim
    (SURVEY.md §2.3), from the compiled sharded HLO at production scale.

    Extracts every all-reduce operand shape from the compiled 8-shard RCE
    step at ``n_nu`` wavenumbers and sums the cross-shard payload bytes.
    The design folds the trapz weights into pointwise multiplies, so the
    only collective reduces [n_levels]-shaped integrals — the payload is
    INDEPENDENT of n_nu, while per-device compute grows linearly with the
    shard width n_nu/k. The efficiency model is

        eff(k) = t_compute / (t_compute + t_latency + bytes/bw)

    and the communication term is printed for NVLink (450 GB/s each way);
    t_compute comes from a measurement on the card.
    """
    import re

    from clearsky_tpu.absorption.gas import DirectGas
    from clearsky_tpu.models.rcm import RCM
    from clearsky_tpu.parallel import spectral_mesh, make_sharded_step
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.utils.grids import pressuregrid
    from clearsky_tpu.constants import R_GAS

    G, MU, CP, PS = 9.8, 0.044, 850.0, 1e5
    lines = SpectralLines.from_par(CO2_PAR, maxlines=maxlines)
    nu_l = np.asarray(lines.nu)
    nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, n_nu)
    dgas = DirectGas.from_lines(lines, 0.95, nu)
    Pe = pressuregrid(10.0, PS, 20)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    r = RCM.create(Pe, Te, G, lambda T, P: MU, 0.0, 0.0,
                   lambda T, P: CP, 1e7, dgas)
    mesh = spectral_mesh(n_nu_shards=n_shards)
    sfn = make_sharded_step(mesh, r, dt=300.0, update_every=1)
    rs, ws = sfn.bound_args
    print(f"compiling the {n_shards}-shard step at n_nu={n_nu} "
          f"({len(nu_l)} lines) for HLO payload audit...", flush=True)
    hlo = sfn.jitted.lower(rs, ws, r.T, rs.A, jnp.asarray(0)).compile().as_text()

    # operand shapes of every all-reduce in the compiled program
    dt_bytes = {"f64": 8, "f32": 4, "bf16": 2, "s32": 4, "u32": 4, "pred": 1}
    payload = 0
    shapes = []
    for m in re.finditer(
        r"=\s*(\w+)\[([\d,]*)\][^=]*\ball-reduce(?:-start)?\(", hlo
    ):
        dt, dims = m.group(1), m.group(2)
        n = int(np.prod([int(d) for d in dims.split(",") if d])) if dims else 1
        payload += n * dt_bytes.get(dt, 4)
        shapes.append(f"{dt}[{dims}]")
    n_ar = len(shapes)
    print(f"all-reduces per step: {n_ar}  shapes: {shapes}")
    print(f"cross-shard payload: {payload} bytes/step (nu-independent by "
          "construction: trapz is folded into pointwise weights)")

    # the collective's cost per step is one latency plus payload/bandwidth;
    # per-device compute is not known here (measure it on the card), so
    # report the communication floor against NVLink (450 GB/s each way)
    lat, bw = 10e-6, 450e9
    print(f"\ncommunication per step over NVLink (~{lat * 1e6:.0f} us latency): "
          f"{(lat + payload / bw) * 1e6:.2f} us — latency-bound, independent "
          "of the spectral width")
    return n_ar, payload


def main():
    from clearsky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from clearsky_tpu import GrayGas, RCM
    from clearsky_tpu.absorption.gas import DirectGas
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.models import rcm as rcm_mod
    from clearsky_tpu.parallel import spectral_mesh, make_sharded_heating, make_sharded_step
    from clearsky_tpu.utils.grids import pressuregrid
    from clearsky_tpu.constants import R_GAS

    G, MU, CP, PS = 9.8, 0.029, 1e3, 1e5
    n_nu = 32768
    nu = np.linspace(1.0, 3000.0, n_nu)
    Pe = pressuregrid(10.0, PS, 24)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    devices = jax.devices()
    print(f"{len(devices)} virtual devices, n_nu={n_nu}")
    print("NOTE: virtual CPU devices share host cores — these numbers validate")
    print("the collective structure and physics identity, not absolute scaling.")

    gas = GrayGas.create(5e-27, nu)
    r = RCM.create(Pe, Te, G, lambda T, P: MU, 0.0, 0.0, lambda T, P: CP, 1e7, gas)
    _bench_column("gray heating (cached sigma)", r, make_sharded_heating,
                  spectral_mesh, devices)

    # the FLAGSHIP column: line-by-line CO2 DirectGas. The sharded step with
    # update_every=1 re-evaluates the Voigt line sum on every shard's own
    # line slab each step — the path the nu mesh exists for.
    if os.path.exists(CO2_PAR):
        lines = SpectralLines.from_par(CO2_PAR, maxlines=2000)
        nu_l = np.asarray(lines.nu)
        nu2 = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, n_nu)
        dgas = DirectGas.from_lines(lines, 0.95, nu2)
        r2 = RCM.create(
            Pe, Te, G, lambda T, P: 0.044, 0.0, 0.0, lambda T, P: 850.0, 1e7, dgas
        )
        print("== CO2 DirectGas RCE step incl. per-step line-sum refresh ==")
        base = None
        T_ref = None
        for k in [1, 2, 4, 8]:
            if k > len(devices):
                break
            mesh = spectral_mesh(n_nu_shards=k, devices=devices[:k])
            sfn = make_sharded_step(mesh, r2, dt=300.0, update_every=1)
            T1, A1 = sfn(r2.T, None, 0)  # compile
            if T_ref is None:
                T_ref = np.asarray(T1)
            else:
                np.testing.assert_allclose(np.asarray(T1), T_ref, rtol=1e-9)
            ts = []
            for i in range(3):
                t0 = time.perf_counter()
                out = sfn(r2.T, None, 0)
                jax.block_until_ready(out)
                ts.append(time.perf_counter() - t0)
            dt_ = min(ts)
            if base is None:
                base = dt_
            print(
                f"  nu-shards={k}: {dt_*1e3:7.1f} ms/step  "
                f"speedup {base/dt_:4.2f}x  (trajectory identical to 1e-9)"
            )


    # the weak-scaling arithmetic at reduced nu (fast); run with
    # --weak-scaling-full for the 2^19 production-scale HLO audit
    if "--weak-scaling-full" in sys.argv:
        weak_scaling_arithmetic(n_nu=524288)
    else:
        weak_scaling_arithmetic(n_nu=32768, maxlines=2000)


if __name__ == "__main__":
    main()
