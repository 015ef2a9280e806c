"""Which implementation runs on which device.

One place decides, so that no module checks the platform on its own:

* GPU: float32 line sums run the Pallas (Triton) kernel of
  :mod:`ops.linesum_gpu`; gas tables are baked on the device
  (sample -> log -> Chebyshev fit without a host round trip).
* CPU (the test suite): the plain ``jax.numpy`` paths.
* float64 line sums (references computed under ``jax.enable_x64``) run
  the plain path on every platform: the kernel is float32 by design.

Any other platform is an error. Nothing here falls back: a kernel that
fails to build on the GPU raises, it is never replaced by the plain path
or run in interpret mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["platform", "linesum_impl", "device_bake"]

_LINESUM = {"gpu": "triton", "cpu": "xla"}


def platform() -> str:
    """The default JAX backend's platform name ('gpu' or 'cpu')."""
    p = jax.default_backend()
    if p not in _LINESUM:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: clearsky_tpu runs on 'gpu' "
            "(NVIDIA) or 'cpu'"
        )
    return p


def linesum_impl(dtype=jnp.float32, on: str | None = None) -> str:
    """Line-sum implementation for ``dtype`` on platform ``on`` (default:
    the current one): ``'triton'`` (the GPU kernel) or ``'xla'`` (the
    plain path)."""
    p = platform() if on is None else on
    if p not in _LINESUM:
        raise RuntimeError(f"no line-sum implementation for platform {p!r}")
    if jnp.dtype(dtype) == jnp.float64:
        return "xla"
    return _LINESUM[p]


def device_bake(on: str | None = None) -> bool:
    """Whether gas tables are baked and fitted on the device."""
    return (platform() if on is None else on) == "gpu"
