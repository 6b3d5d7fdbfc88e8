"""Sparse (virtual-angle) channel representation.

JAX rewrite of ``Sparse_Channel_Formulation``:
  ref: main/src/generate_channel/Sparse_Channel_Formulation.m:65-181.

The FoV window and dictionary are static (depend only on config), so they are
built once with numpy; the ground-truth sparse vector z and the leakage
diagnostics are traced JAX ops batched over U.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ArrayConfig
from .channel import Channel
from .steering import dictionary, fov_window, virtual_grid


class SparseRepresentation(NamedTuple):
    ad: jax.Array            #: (nt*nr, P) FoV-reduced dictionary
    z: jax.Array             #: (U, P) ground-truth sparse coefficient vector
    z_leakage: jax.Array     #: (U, P) projection of H onto the grid (leakage)
    tx_window: np.ndarray    #: static Tx grid indices of the FoV window
    rx_window: np.ndarray    #: static Rx grid indices of the FoV window
    a_tx: jax.Array          #: (nt, grid_t) full Tx dictionary
    a_rx: jax.Array          #: (nr, grid_r) full Rx dictionary


def sparse_formulation(cfg: ArrayConfig, channel: Channel,
                       searching_area_deg: float,
                       dtype=jnp.complex64) -> SparseRepresentation:
    """Build AD, ground-truth z, and leakage for a batch of channels.

    ref: Sparse_Channel_Formulation.m:65-181.  The grid is in *virtual angle*
    space ``k_d * sin(theta)``; nearest-neighbor quantization determines the
    support of z (ref :95-116); AD columns are
    ``kron(conj(a_tx[:,u]), a_rx[:,v])`` over the FoV window (ref :140-148).
    """
    tx_idx, rx_idx = fov_window(cfg, searching_area_deg)
    n_u, n_v = len(tx_idx), len(rx_idx)

    a_tx_full = dictionary(cfg.nt, cfg.grid_t, cfg.k_d, dtype)
    a_rx_full = dictionary(cfg.nr, cfg.grid_r, cfg.k_d, dtype)
    a_tx = a_tx_full[:, tx_idx]
    a_rx = a_rx_full[:, rx_idx]
    ad = jnp.einsum("tu,rv->truv", jnp.conj(a_tx), a_rx)
    ad = ad.reshape(cfg.nt * cfg.nr, n_u * n_v)

    rdt = channel.aod_deg.dtype
    grid_t = jnp.asarray(virtual_grid(cfg.grid_t), rdt)  # sin-space
    grid_r = jnp.asarray(virtual_grid(cfg.grid_r), rdt)

    # Nearest grid index per path, in *full-grid* coordinates (ref :99-106).
    sin_aod = jnp.sin(jnp.deg2rad(channel.aod_deg))      # (U, L)
    sin_aoa = jnp.sin(jnp.deg2rad(channel.aoa_deg))
    pos_t = jnp.argmin(jnp.abs(grid_t[None, None] - sin_aod[..., None]), -1)
    pos_r = jnp.argmin(jnp.abs(grid_r[None, None] - sin_aoa[..., None]), -1)

    # Reduced-window flat position (u - u1) * n_v + (v - v1) (ref :108-116,139).
    u_rel = pos_t - int(tx_idx[0])
    v_rel = pos_r - int(rx_idx[0])
    flat = u_rel * n_v + v_rel                           # (U, L)
    in_window = ((u_rel >= 0) & (u_rel < n_u) & (v_rel >= 0) & (v_rel < n_v))
    flat = jnp.where(in_window, flat, 0)

    batch, L = channel.gains.shape
    z = jnp.zeros((batch, n_u * n_v), dtype)
    gains = jnp.where(in_window, channel.gains, 0.0)
    z = jax.vmap(lambda zi, fi, gi: zi.at[fi].add(gi))(z, flat, gains)

    # Leakage: vec(A_Rx^H H A_Tx) over the FoV window, Rx index fastest
    # (ref :153-160).
    leak = jnp.einsum("rv,urt,tw->uwv", jnp.conj(a_rx), channel.h_matrix, a_tx)
    z_leakage = leak.reshape(batch, n_u * n_v)

    return SparseRepresentation(ad=ad, z=z, z_leakage=z_leakage,
                                tx_window=tx_idx, rx_window=rx_idx,
                                a_tx=a_tx_full, a_rx=a_rx_full)
