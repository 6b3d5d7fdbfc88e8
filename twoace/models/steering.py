"""ULA steering vectors and virtual-angle (DFT-like) dictionaries.

JAX rewrite of the steering-vector loops in
  - ref: main/src/generate_channel/Generate_Channel.m:127-148
  - ref: main/src/generate_channel/Sparse_Channel_Formulation.m:76-93

Everything is vectorized/batched (no per-angle Python loops) and pure so it
can live inside ``jit``/``vmap`` regions.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import ArrayConfig


def steering_vector(sin_theta, n: int, k_d: float, dtype=jnp.complex64):
    """a(theta)[k] = exp(-1j * k_d * sin(theta) * k) / sqrt(n), k = 0..n-1.

    ``sin_theta`` may have any batch shape; returns shape ``(*batch, n)``.
    ref: Generate_Channel.m:132-133.
    """
    sin_theta = jnp.asarray(sin_theta)
    k = jnp.arange(n, dtype=jnp.result_type(sin_theta, jnp.float32))
    phase = -k_d * sin_theta[..., None] * k
    return jnp.exp(1j * phase.astype(_real_dtype(dtype))).astype(dtype) / np.sqrt(n)


def _real_dtype(cdtype):
    return jnp.float64 if jnp.dtype(cdtype) == jnp.complex128 else jnp.float32


def virtual_grid(nq: int) -> np.ndarray:
    """The sin-space grid ``linspace(-1,1,NQ+1)(1:end-1)``.

    ref: Sparse_Channel_Formulation.m:76-79.  Static (numpy) — grid geometry
    depends only on the config.
    """
    return np.linspace(-1.0, 1.0, nq + 1)[:-1]


def dictionary(n: int, nq: int, k_d: float, dtype=jnp.complex64):
    """Tx/Rx steering dictionary over the virtual grid: shape ``(n, nq)``.

    Column u is the steering vector at virtual angle ``k_d * grid[u]``.
    ref: Sparse_Channel_Formulation.m:84-93.
    """
    grid = virtual_grid(nq)
    # virtual angle already includes k_d; steering phase = -virt * k
    virt = k_d * grid
    k = np.arange(n)
    a = np.exp(-1j * np.outer(k, virt)) / np.sqrt(n)
    return jnp.asarray(a, dtype=dtype)


def fov_window(cfg: ArrayConfig, searching_area_deg: float):
    """Static FoV restriction of the virtual grid to +-searching_area/2.

    Returns ``(tx_idx, rx_idx)`` integer numpy arrays: the contiguous index
    windows [u1..u2], [v1..v2] of the Tx/Rx grids nearest to the FoV edges.
    ref: Sparse_Channel_Formulation.m:119-137.
    """
    half = np.deg2rad(searching_area_deg / 2.0)
    lo, hi = -np.sin(half), np.sin(half)

    def window(nq):
        grid = virtual_grid(nq)
        i_lo = int(np.argmin(np.abs(grid - lo)))
        i_hi = int(np.argmin(np.abs(grid - hi)))
        return np.arange(i_lo, i_hi + 1)

    return window(cfg.grid_t), window(cfg.grid_r)


def angle_dictionary(cfg: ArrayConfig, searching_area_deg: float,
                     dtype=jnp.complex64):
    """The FoV-reduced virtual-angle dictionary AD: shape ``(nt*nr, P)``.

    Column (u, v) is ``kron(conj(a_tx[:, u]), a_rx[:, v])`` — Rx index
    varies fastest, matching vec(H) with H of shape (Nr, Nt) in column-major
    order.  ref: Sparse_Channel_Formulation.m:140-148.
    """
    tx_idx, rx_idx = fov_window(cfg, searching_area_deg)
    a_tx = dictionary(cfg.nt, cfg.grid_t, cfg.k_d, dtype)[:, tx_idx]
    a_rx = dictionary(cfg.nr, cfg.grid_r, cfg.k_d, dtype)[:, rx_idx]
    # AD[(it*nr + ir), (u*|rx| + v)] = conj(a_tx[it, u]) * a_rx[ir, v]
    ad = jnp.einsum("tu,rv->truv", jnp.conj(a_tx), a_rx)
    return ad.reshape(cfg.nt * cfg.nr, a_tx.shape[1] * a_rx.shape[1])


def vec_channel(h_matrix):
    """vec(H) with H of shape ``(..., nr, nt)`` -> ``(..., nt*nr)``.

    MATLAB column-major vec: Rx index fastest (ref: Generate_Channel.m:158-161).
    """
    h = jnp.asarray(h_matrix)
    return jnp.swapaxes(h, -1, -2).reshape(*h.shape[:-2], -1)


def unvec_channel(vec_h, nr: int, nt: int):
    """Inverse of :func:`vec_channel`: ``(..., nt*nr)`` -> ``(..., nr, nt)``."""
    v = jnp.asarray(vec_h)
    return jnp.swapaxes(v.reshape(*v.shape[:-1], nt, nr), -1, -2)
