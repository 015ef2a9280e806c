"""Device meshes and spectral-axis sharding.

The reference parallelizes over the wavenumber axis with shared-memory threads
(ClearSky.jl ``fluxes.jl:61,93,152,185,228,270``); the accelerator equivalent
is a device mesh with the wavenumber grid sharded in contiguous blocks across
devices, plus an optional batch axis for column sweeps (SURVEY.md §2.3).

Every per-wavenumber computation in the framework is embarrassingly parallel;
the single cross-shard reduction is the spectral integral ``trapz(nu, M)``
(ref shared.jl:125-136). :func:`trapz_weights` rewrites that integral as an
elementwise weighted sum so it shards cleanly — under GSPMD it lowers to one
all-reduce over the ``nu`` axis; under ``shard_map`` it is an explicit
``lax.psum``.

Axis conventions:
  * ``"nu"``  — spectral/model axis: last dimension of every [..., n_nu] array
  * ``"batch"`` — data axis: leading dimension of batched column states
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "init_multihost",
    "spectral_mesh",
    "trapz_weights",
    "shard_spectral",
    "replicate",
    "nu_spec",
    "spectral_pspecs",
]


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> tuple[int, int]:
    """Initialize the multi-host distributed runtime; returns
    ``(process_index, process_count)``.

    The reference is a single shared-memory process (SURVEY.md §2.3); scaling
    the ('batch', 'nu') mesh beyond one host requires
    ``jax.distributed.initialize`` before any device is touched, after which
    :func:`spectral_mesh` sees the global device set and the spectral psum
    spans every host's devices. Call this once per process,
    before building meshes:

        init_multihost("host0:1234", num_processes=4, process_id=rank)
        mesh = spectral_mesh(n_batch=2)   # global devices

    With no arguments, managed environments (SLURM, Open MPI) are
    auto-detected; a plain single process (nothing to detect, or already
    initialized) is a no-op, so library code can call this unconditionally.
    """
    if coordinator_address is None and num_processes in (None, 1) and process_id is None:
        try:  # auto-detect managed clusters; plain single process stays local
            jax.distributed.initialize(**kwargs)
        except (RuntimeError, ValueError) as e:
            # Only a true "nothing to detect / already initialized" case may
            # degrade to single-process. If a managed-cluster environment IS
            # present (SLURM, Open MPI), a failure here means the
            # coordinator is unreachable or the env is inconsistent — running
            # every rank as process 0 of 1 would silently break collectives,
            # so fail loudly instead (advisor finding, round 2).
            def _multi(v):
                raw = os.environ.get(v, "")
                if not raw:
                    return False
                try:
                    return int(raw) > 1
                except ValueError:
                    return True  # unparseable size var: be loud, not silent
            checks = {
                "SLURM_NTASKS": _multi("SLURM_NTASKS"),
                "OMPI_COMM_WORLD_SIZE": _multi("OMPI_COMM_WORLD_SIZE"),
                "PMI_SIZE": _multi("PMI_SIZE"),
                "COORDINATOR_ADDRESS": bool(os.environ.get("COORDINATOR_ADDRESS")),
                "JAX_COORDINATOR_ADDRESS": bool(os.environ.get("JAX_COORDINATOR_ADDRESS")),
            }
            cluster_vars = [k for k, hit in checks.items() if hit]
            if cluster_vars:
                raise RuntimeError(
                    "jax.distributed.initialize() failed while managed-cluster "
                    f"environment variables are set ({', '.join(cluster_vars)}); "
                    "refusing to degrade to a single process. Fix the cluster "
                    "env or pass coordinator_address/num_processes/process_id "
                    "explicitly."
                ) from e
            warnings.warn(
                f"init_multihost: auto-detect found no cluster ({e}); "
                "continuing as a single process.",
                RuntimeWarning,
                stacklevel=2,
            )
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    return jax.process_index(), jax.process_count()


def spectral_mesh(n_nu_shards: int | None = None, n_batch: int = 1, devices=None) -> Mesh:
    """Build a ('batch', 'nu') device mesh.

    With defaults, all devices go to the spectral axis — the analogue of the
    reference threading over wavenumber. ``n_batch > 1`` splits devices between
    a column-batch axis and the spectral axis.
    """
    devices = jax.devices() if devices is None else list(devices)
    n = len(devices)
    if n_nu_shards is None:
        n_nu_shards = n // n_batch
    if n_batch * n_nu_shards != n:
        raise ValueError(
            f"mesh size {n_batch}x{n_nu_shards} does not match {n} devices"
        )
    dev = np.asarray(devices).reshape(n_batch, n_nu_shards)
    return Mesh(dev, ("batch", "nu"))


def trapz_weights(nu) -> jnp.ndarray:
    """Weights w with trapz(nu, y) == sum(w * y) exactly.

    Turns the spectral trapezoid integral into a pointwise weighted reduction —
    the form that shards over the ``nu`` axis with a single all-reduce and no
    neighbor halo (the boundary terms are folded into the static weights).
    """
    nu = jnp.asarray(nu)
    dn = nu[1:] - nu[:-1]
    w_first = 0.5 * dn[:1]
    w_last = 0.5 * dn[-1:]
    w_mid = 0.5 * (dn[1:] + dn[:-1])
    return jnp.concatenate([w_first, w_mid, w_last])


def nu_spec(ndim: int) -> P:
    """PartitionSpec sharding only the last of ``ndim`` axes over 'nu'."""
    return P(*([None] * (ndim - 1) + ["nu"]))


def _is_spectral(x, n_nu: int) -> bool:
    return hasattr(x, "ndim") and x.ndim >= 1 and x.shape[-1] == n_nu


def _has_own_specs(x) -> bool:
    """Nodes that carry their own PartitionSpec tree (e.g. ShardedLineGas,
    whose leading shard axis — not a trailing n_nu axis — maps to 'nu')."""
    return hasattr(x, "pspecs")


def spectral_pspecs(tree, n_nu: int):
    """PartitionSpecs for a pytree: last-axis 'nu' for spectral leaves,
    replicated otherwise. Nodes exposing ``pspecs()`` (sharded line-by-line
    gases) supply their own spec subtree. Batched column states place their
    leading axis explicitly (see ``models.sweep.shard_sweep``)."""

    def spec(x):
        if _has_own_specs(x):
            return x.pspecs()
        if not hasattr(x, "ndim"):
            return P()
        parts = [None] * x.ndim
        if _is_spectral(x, n_nu):
            parts[-1] = "nu"
        return P(*parts)

    return jax.tree.map(spec, tree, is_leaf=_has_own_specs)


def shard_spectral(tree, mesh: Mesh, n_nu: int):
    """Place a pytree on the mesh: leaves with trailing dim n_nu sharded over
    'nu', everything else replicated. Works on any absorber/model pytree;
    nodes exposing ``pspecs()`` are placed leaf-by-leaf per their own specs."""

    def put(x):
        if _has_own_specs(x):
            return jax.tree.map(
                lambda leaf, s: jax.device_put(leaf, NamedSharding(mesh, s)),
                x,
                x.pspecs(),
            )
        if not hasattr(x, "ndim"):
            return x
        if _is_spectral(x, n_nu):
            return jax.device_put(x, NamedSharding(mesh, nu_spec(x.ndim)))
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(put, tree, is_leaf=_has_own_specs)


def replicate(tree, mesh: Mesh):
    """Replicate every leaf of a pytree across the mesh."""
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())) if hasattr(x, "ndim") else x,
        tree,
    )
