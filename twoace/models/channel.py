"""Eq.-23 sparse multipath channel sampler.

JAX rewrite of ``Generate_Channel`` / ``Generate_Dynamic_Channel``:
  - ref: main/src/generate_channel/Generate_Channel.m:64-164
  - ref: main/src/generate_channel/Generate_Dynamic_Channel.m:1-78
  - ref: main/src/others/construct_channel_representation.m:18-31

Design: a pure function over an explicit PRNG key returning a ``Channel``
pytree.  The batch axis U is a real array axis (vmap-free batching), so a
whole Monte-Carlo population is generated in one fused XLA computation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ArrayConfig, ChannelConfig
from .steering import steering_vector, virtual_grid, vec_channel


class Channel(NamedTuple):
    """Synthetic channel instance(s); all leaves carry the batch axis U."""

    aod_deg: jax.Array        #: (U, L) dominant-path AoD in degrees
    aoa_deg: jax.Array        #: (U, L) dominant-path AoA in degrees
    gains: jax.Array          #: (U, L) normalized complex path gains
    h_matrix: jax.Array       #: (U, nr, nt) CSI matrix H
    vec_h: jax.Array          #: (U, nt*nr) vec(H), Rx index fastest
    h_dominant: jax.Array     #: (U, nr, nt) LOS/dominant component
    h_undominant: jax.Array   #: (U, nr, nt) Rician NLOS component


def _complex_normal(key, shape, dtype):
    kr, ki = jax.random.split(key)
    rdt = jnp.float64 if jnp.dtype(dtype) == jnp.complex128 else jnp.float32
    return ((jax.random.normal(kr, shape, rdt)
             + 1j * jax.random.normal(ki, shape, rdt)) / np.sqrt(2.0)).astype(dtype)


def _path_response(aod_rad, aoa_rad, gains, cfg: ArrayConfig, dtype):
    """H = sqrt(Nt*Nr) * ARx diag(h) ATx^H  (ref: Generate_Channel.m:127-136)."""
    a_tx = steering_vector(jnp.sin(aod_rad), cfg.nt, cfg.k_d, dtype)  # (U,L,nt)
    a_rx = steering_vector(jnp.sin(aoa_rad), cfg.nr, cfg.k_d, dtype)  # (U,L,nr)
    scale = np.sqrt(cfg.nt * cfg.nr)
    return scale * jnp.einsum("ulr,ul,ult->urt", a_rx, gains, jnp.conj(a_tx))


def _snap_to_grid(angles_deg, nq: int):
    """Snap angles to the sin-space virtual grid (ref: Generate_Channel.m:85-101)."""
    grid = jnp.asarray(virtual_grid(nq), jnp.result_type(angles_deg, jnp.float32))
    s = jnp.sin(jnp.deg2rad(angles_deg))
    idx = jnp.argmin(jnp.abs(grid[None, None, :] - s[..., None]), axis=-1)
    return jnp.rad2deg(jnp.arcsin(grid[idx]))


def generate_channel(key, cfg: ArrayConfig, ch: ChannelConfig, batch: int = 1,
                     dtype=jnp.complex64) -> Channel:
    """Sample ``batch`` independent Eq.-23 channels.

    ref: Generate_Channel.m:64-164.  Notes on replicated semantics:
      - AoD/AoA ~ U(-SA/2, +SA/2) degrees (ref :77-84)
      - gains CN(0,1)/sqrt(2), normalized to unit norm per instance (ref :104-108)
      - Rician NLOS paths only when L == 1, angles U(-90, 90) (ref :109-124)
      - 7 dB K-factor mixing (ref :150-157)
    """
    L = ch.n_paths
    half = ch.searching_area_deg / 2.0
    keys = jax.random.split(key, 6)
    rdt = jnp.float64 if jnp.dtype(dtype) == jnp.complex128 else jnp.float32

    if ch.fix_angles:
        aod = jnp.zeros((batch, L), rdt)
        aoa = jnp.full((batch, L), 15.0, rdt)
    else:
        aod = jax.random.uniform(keys[0], (batch, L), rdt, -half, half)
        aoa = jax.random.uniform(keys[1], (batch, L), rdt, -half, half)
    if ch.on_grid:
        aod = _snap_to_grid(aod, cfg.grid_t)
        aoa = _snap_to_grid(aoa, cfg.grid_r)

    gains = _complex_normal(keys[2], (batch, L), dtype)
    gains = gains / jnp.linalg.norm(gains, axis=-1, keepdims=True)

    h_dom = _path_response(jnp.deg2rad(aod), jnp.deg2rad(aoa), gains, cfg, dtype)

    # Rician NLOS component (only for single dominant path, ref :109-114)
    rician_k = ch.rician_k if L == 1 else 0
    if rician_k > 0:
        nlos_gains = _complex_normal(keys[3], (batch, rician_k), dtype)
        nlos_gains = nlos_gains / jnp.linalg.norm(nlos_gains, axis=-1, keepdims=True)
        aod_n = jax.random.uniform(keys[4], (batch, rician_k), rdt,
                                   -np.pi / 2, np.pi / 2)
        aoa_n = jax.random.uniform(keys[5], (batch, rician_k), rdt,
                                   -np.pi / 2, np.pi / 2)
        h_und = _path_response(aod_n, aoa_n, nlos_gains, cfg, dtype)
        k_factor = 10.0 ** (ch.k_factor_db / 10.0)
        h = (np.sqrt(k_factor / (k_factor + 1.0)) * h_dom
             + np.sqrt(1.0 / (k_factor + 1.0)) * h_und)
    else:
        h_und = jnp.zeros_like(h_dom)
        h = h_dom

    return Channel(aod_deg=aod, aoa_deg=aoa, gains=gains, h_matrix=h,
                   vec_h=vec_channel(h), h_dominant=h_dom, h_undominant=h_und)


def perturb_channel(key, channel: Channel, cfg: ArrayConfig,
                    max_angle_change_deg: float, dtype=jnp.complex64) -> Channel:
    """Mobility model: jitter AoD/AoA by <= ``max_angle_change_deg``, keep gains.

    ref: Generate_Dynamic_Channel.m:1-78.
    """
    k1, k2 = jax.random.split(key)
    rdt = channel.aod_deg.dtype
    d_aod = jax.random.uniform(k1, channel.aod_deg.shape, rdt,
                               -max_angle_change_deg, max_angle_change_deg)
    d_aoa = jax.random.uniform(k2, channel.aoa_deg.shape, rdt,
                               -max_angle_change_deg, max_angle_change_deg)
    aod = channel.aod_deg + d_aod
    aoa = channel.aoa_deg + d_aoa
    h_dom = _path_response(jnp.deg2rad(aod), jnp.deg2rad(aoa), channel.gains,
                           cfg, dtype)
    return Channel(aod_deg=aod, aoa_deg=aoa, gains=channel.gains,
                   h_matrix=h_dom, vec_h=vec_channel(h_dom),
                   h_dominant=h_dom, h_undominant=jnp.zeros_like(h_dom))


def from_matrix(h_matrix, normalize: bool = False) -> Channel:
    """Wrap a measured / ray-traced H trace into a ``Channel``.

    ref: main/src/others/construct_channel_representation.m:18-31 (which
    normalizes each entry to unit magnitude: ``H ./ abs(H)``).
    """
    h = jnp.asarray(h_matrix)
    if h.ndim == 2:
        h = h[None]
    if normalize:
        h = h / jnp.maximum(jnp.abs(h), 1e-30)
    batch = h.shape[0]
    zero = jnp.zeros((batch, 1), h.real.dtype)
    czero = jnp.zeros((batch, 1), h.dtype)
    return Channel(aod_deg=zero, aoa_deg=zero, gains=czero, h_matrix=h,
                   vec_h=vec_channel(h), h_dominant=h,
                   h_undominant=jnp.zeros_like(h))
