"""Tracing, device peaks and kernel cost accounting.

* :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-compatible trace directory.
* :data:`DEVICE_PEAKS` / :func:`device_peaks` — published peak rates of the
  devices this program measures on, keyed by ``device_kind``. A device that
  is not in the table is an error, not a default.
* :func:`linesum_cost` — analytic FLOP/byte model of the plain line sum (the
  framework's hot op), from the static banding plan.
* :func:`roofline_report` — measured time against the roofline that the
  cost model and a device's peaks imply.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = [
    "trace",
    "card_name_and_power_limit",
    "DEVICE_PEAKS",
    "device_peaks",
    "linesum_cost",
    "roofline_report",
]

# (peak float32 FLOP/s outside the tensor cores, device-memory bytes/s),
# keyed by jax.Device.device_kind. Source: NVIDIA H100 data sheet, SXM5
# part, dense rates (67 TFLOP/s FP32, 3.35 TB/s HBM3), at the full 700 W
# power limit; a card set below it cannot hold its top clock.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}

# FLOPs of one Voigt profile evaluation in the branch-free Humlicek kernel:
# all four regions computed per element (region arithmetic ~ 130 flops) plus
# scaling/masking (~25) — an engineering estimate for roofline context.
VOIGT_FLOPS_PER_EVAL = 155.0


def device_peaks(device_kind: str) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) of a device kind; unknown kinds raise."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "clearsky_tpu.utils.profiling.DEVICE_PEAKS with its source"
        ) from None


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), the record every device number is kept with."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: ``with trace('/tmp/trace'): run()`` -> TensorBoard dir."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float          # dense FLOPs actually executed
    useful_flops: float   # FLOPs on in-window (physically counted) pairs
    bytes_moved: float    # device-memory traffic (inputs + outputs)
    evals: int            # in-window line evaluations

    @property
    def intensity(self) -> float:
        """Arithmetic intensity [FLOP/byte]."""
        return self.flops / max(self.bytes_moved, 1.0)


def linesum_cost(plan, n_states: int, chunk: int | None = None,
                 dtype_bytes: int = 4) -> KernelCost:
    """Cost model of a line sum that walks each block's own window.

    Dense work walks ceil(count/chunk)*chunk lines per block (the GPU
    kernel's per-block trip count; ``chunk`` defaults to
    ``ops.linesum_gpu.CHUNK``); useful work
    is the in-window pair count. Bytes: the per-block line slabs for
    (S, alpha, gamma) per state plus the shared line positions, and the
    output stripe.
    """
    if chunk is None:
        from ..ops.linesum_gpu import CHUNK as chunk
    counts = np.asarray(plan.count, dtype=np.int64)
    walked = np.ceil(counts / chunk).astype(np.int64) * chunk
    dense_pairs = int(walked.sum()) * plan.block * n_states
    useful_pairs = int(counts.sum()) * plan.block * n_states
    bytes_slabs = int(walked.sum()) * dtype_bytes * (2 + 3 * n_states)
    bytes_out = plan.n_blocks * plan.block * n_states * dtype_bytes
    return KernelCost(
        flops=dense_pairs * VOIGT_FLOPS_PER_EVAL,
        useful_flops=useful_pairs * VOIGT_FLOPS_PER_EVAL,
        bytes_moved=float(bytes_slabs + bytes_out),
        evals=useful_pairs,
    )


def roofline_report(cost: KernelCost, seconds: float, device_kind: str) -> dict:
    """Roofline context for a measured run of ``cost`` on ``device_kind``.

    ``fraction_of_roof`` is achieved model FLOP/s over the binding roof
    (compute vs bandwidth at the kernel's arithmetic intensity). The per-eval
    op count is an engineering estimate, so treat the fraction as a scale.
    """
    peak_flops, peak_bw = device_peaks(device_kind)
    achieved = cost.flops / seconds
    roof = min(peak_flops, peak_bw * cost.intensity)
    return {
        "achieved_flops": achieved,
        "peak_flops": peak_flops,
        "intensity_flop_per_byte": cost.intensity,
        "binding_roof_flops": roof,
        "bound": "compute" if roof == peak_flops else "memory",
        "fraction_of_roof": achieved / roof,
        "useful_evals_per_s": cost.evals / seconds,
    }
