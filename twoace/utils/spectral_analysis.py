"""Spectral-profile (power-law) analysis of channel matrices.

JAX rewrite of the analysis scripts that motivate the 2ACE prox
design (ref: Numerical_Simulation/src/others/):
  - ``variance_of_K_singular_values.m:1-24`` — per-k captured energy
  - ``plot_deviation_from_power_law.m:10-30`` — deviation of a channel's
    singular-value profile from the A1/A2 constraint ladders
  - ``eig_decay.m`` — eigenvalue decay curves
  - ``nuclear_norm.m:1-15`` / ``plot_l1_norm.m`` — norm summaries
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..ops.prox import profile_ladder


def singular_profile(h_matrix):
    """Squared singular values of H, descending, batched ``(..., k)``."""
    s = jnp.linalg.svd(h_matrix, compute_uv=False)
    return jnp.sort(s * s, axis=-1)[..., ::-1]


def captured_energy(h_matrix):
    """Cumulative energy fraction captured by the top-k singular values.

    ref: variance_of_K_singular_values.m:1-24.
    """
    s2 = singular_profile(h_matrix)
    csum = jnp.cumsum(s2, axis=-1)
    return csum / jnp.maximum(csum[..., -1:], 1e-30)


def ladder_deviation(h_matrix, nt: int, nr: int,
                     mode: str = "v4") -> Dict[str, jax.Array]:
    """How far a channel's spectral profile violates each ladder level.

    Positive deviation = the top-r energy falls short of the required
    fraction f (the prox would rescale).  ref: plot_deviation_from_power_law.m.
    """
    frac = captured_energy(h_matrix)
    ladder = profile_ladder(nt, nr, m=0, n=nt * nr, use_rank_one=False,
                            mode=mode)
    out = {}
    for r, f in ladder:
        out[f"C({r},{f})"] = jnp.maximum(f - frac[..., r - 1], 0.0)
    return out


def eig_decay(h_matrix):
    """Normalized eigenvalue (squared singular value) decay curve."""
    s2 = singular_profile(h_matrix)
    return s2 / jnp.maximum(s2[..., :1], 1e-30)


def nuclear_norm(h_matrix):
    """||H||_* (ref: nuclear_norm.m:1-15)."""
    s = jnp.linalg.svd(h_matrix, compute_uv=False)
    return jnp.sum(s, axis=-1)


def l1_norm(vec_z):
    """||z||_1 of the sparse representation (ref: plot_l1_norm.m)."""
    return jnp.sum(jnp.abs(vec_z), axis=-1)


def power_law_fit(h_matrix) -> Tuple[jax.Array, jax.Array]:
    """Least-squares power-law exponent of the singular profile:
    log s2_k ~ alpha * log k + c.  Returns (alpha, residual)."""
    s2 = singular_profile(h_matrix)
    k = jnp.arange(1, s2.shape[-1] + 1, dtype=s2.dtype)
    x = jnp.log(k)
    y = jnp.log(jnp.maximum(s2, 1e-30))
    xm = jnp.mean(x)
    ym = jnp.mean(y, axis=-1, keepdims=True)
    alpha = jnp.sum((x - xm) * (y - ym), axis=-1) \
        / jnp.sum((x - xm) ** 2)
    resid = y - (ym + alpha[..., None] * (x - xm))
    return alpha, jnp.sqrt(jnp.mean(resid ** 2, axis=-1))
