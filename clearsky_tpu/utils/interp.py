"""Device-resident interpolation primitives.

Array-first replacements for the reference's BasicInterpolators dependency
(used at ClearSky.jl ``gases.jl:69-85``, ``collision_induced_absorption.jl:151-152``,
``absorbers.jl:116``, ``atmospherics.jl:7,147``):

* linear interpolation with linear extrapolation (``NoBoundaries`` semantics),
* Chebyshev interpolation as dense matrix contractions (MXU-friendly) — the
  equivalent of ``BichebyshevInterpolator``,
* bilinear interpolation on rectilinear grids (CIA tables).

Everything here is jit/vmap-safe and shape-static.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "interp_linear",
    "cheb_basis",
    "cheb_coeff_matrix",
    "cheb2d_coeffs",
    "cheb2d_eval",
    "bilinear",
]


def interp_linear(x, xp, fp, extrapolate: bool = True):
    """Piecewise-linear interpolation of fp(xp) at x, linearly extrapolating.

    ``xp`` must be ascending. Unlike ``jnp.interp`` (which clamps), this
    extrapolates with the edge-cell slopes, matching the reference's
    ``LinearInterpolator(..., NoBoundaries())`` behavior.

    Supports batched ``fp`` with shape [..., len(xp)]; interpolation runs along
    the last axis. ``x`` may be any shape; result shape is fp.shape[:-1] + x.shape.
    """
    x = jnp.asarray(x)
    xp = jnp.asarray(xp)
    fp = jnp.asarray(fp)
    n = xp.shape[0]
    # index of the left node of the containing cell, clipped to valid cells
    i = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0, n - 2)
    x0 = xp[i]
    x1 = xp[i + 1]
    f0 = jnp.take(fp, i, axis=-1)
    f1 = jnp.take(fp, i + 1, axis=-1)
    t = (x - x0) / (x1 - x0)
    if not extrapolate:
        t = jnp.clip(t, 0.0, 1.0)
    return f0 + t * (f1 - f0)


def cheb_basis(x, a: float, b: float, n: int):
    """Chebyshev polynomial basis T_0..T_{n-1} evaluated at x mapped from [a,b].

    Returns array of shape x.shape + (n,). Uses the recurrence (Clenshaw-free,
    basis-explicit) so that interpolation becomes a dense matmul on the MXU.
    """
    x = jnp.asarray(x)
    xi = 2.0 * (x - a) / (b - a) - 1.0
    cols = [jnp.ones_like(xi), xi]
    for _ in range(2, n):
        cols.append(2.0 * xi * cols[-1] - cols[-2])
    return jnp.stack(cols[:n], axis=-1)


def cheb_coeff_matrix(n: int) -> np.ndarray:
    """Matrix M such that coeffs = M @ values for values on chebygrid nodes.

    Nodes are the ascending Chebyshev-extreme points (see utils.grids.chebygrid).
    Computed host-side once; it is tiny (n <= ~32) and well conditioned.
    """
    k = np.arange(n)
    xi = -np.cos(np.pi * k / (n - 1))  # ascending nodes in [-1,1]
    # Vandermonde of Chebyshev basis at nodes: A[i, j] = T_j(xi_i)
    A = np.cos(np.arange(n)[None, :] * np.arccos(np.clip(xi, -1, 1))[:, None])
    return np.linalg.solve(A, np.eye(n))


def cheb2d_coeffs(values, nx: int | None = None, ny: int | None = None):
    """2-D Chebyshev coefficients from values on a chebygrid x chebygrid tensor grid.

    ``values`` has shape [..., nx, ny] (trailing two axes are the grid). Returns
    coefficients of the same shape. This is the bake-time transform behind the
    reference's ``BichebyshevInterpolator`` (ref gases.jl:80).
    """
    values = jnp.asarray(values)
    nx = values.shape[-2] if nx is None else nx
    ny = values.shape[-1] if ny is None else ny
    Mx = jnp.asarray(cheb_coeff_matrix(nx), dtype=values.dtype)
    My = jnp.asarray(cheb_coeff_matrix(ny), dtype=values.dtype)
    # C = Mx @ V @ My^T along the trailing axes. Precision.HIGHEST: a
    # default-precision f32 matmul may run in TF32 on the GPU (10-bit
    # mantissa) — on ln(sigma) values of magnitude ~50-90 that is a ~0.05
    # absolute error in ln, i.e. percents in sigma after exp. The transform
    # is bake-time and small, so full f32 costs little.
    return jnp.einsum("ij,...jk,lk->...il", Mx, values, My,
                      precision=jax.lax.Precision.HIGHEST)


def cheb2d_eval(coeffs, x, ax: float, bx: float, y, ay: float, by: float):
    """Evaluate 2-D Chebyshev expansion at paired query points (x[i], y[i]).

    ``coeffs``: [..., nx, ny]; x, y: [L]. Returns [..., L]. The contraction is
    expressed as dense matmuls so XLA maps it onto the MXU — this is the
    device-side equivalent of per-point ``BichebyshevInterpolator`` evaluation
    (ref gases.jl:85).
    """
    coeffs = jnp.asarray(coeffs)
    nx, ny = coeffs.shape[-2], coeffs.shape[-1]
    Bx = cheb_basis(x, ax, bx, nx)  # [L, nx]
    By = cheb_basis(y, ay, by, ny)  # [L, ny]
    # result[..., l] = Bx[l, :] @ coeffs[...] @ By[l, :]. HIGHEST for the
    # same reason as cheb2d_coeffs above: bf16-truncated default matmuls
    # destroy large-magnitude ln-space expansions.
    return jnp.einsum("li,...ij,lj->...l", Bx, coeffs, By,
                      precision=jax.lax.Precision.HIGHEST)


def bilinear(x, y, xp, yp, fp, extrapolate: bool = True):
    """Bilinear interpolation of fp on grid (xp, yp) at paired points (x, y).

    fp: [..., len(xp), len(yp)]; x, y broadcastable arrays. Extrapolates
    linearly outside the grid unless ``extrapolate`` is False (clamps).
    """
    xp = jnp.asarray(xp)
    yp = jnp.asarray(yp)
    fp = jnp.asarray(fp)
    nx, ny = xp.shape[0], yp.shape[0]
    i = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0, nx - 2)
    j = jnp.clip(jnp.searchsorted(yp, y, side="right") - 1, 0, ny - 2)
    tx = (x - xp[i]) / (xp[i + 1] - xp[i])
    ty = (y - yp[j]) / (yp[j + 1] - yp[j])
    if not extrapolate:
        tx = jnp.clip(tx, 0.0, 1.0)
        ty = jnp.clip(ty, 0.0, 1.0)
    f00 = fp[..., i, j]
    f10 = fp[..., i + 1, j]
    f01 = fp[..., i, j + 1]
    f11 = fp[..., i + 1, j + 1]
    return (
        f00 * (1 - tx) * (1 - ty)
        + f10 * tx * (1 - ty)
        + f01 * (1 - tx) * ty
        + f11 * tx * ty
    )
