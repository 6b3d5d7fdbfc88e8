"""Spectral initialization for magnitude-only recovery.

ref: inferLowRankV4_multi.m:561-574 (SpectralInitialize).  Rows of A are
scaled by B_i / ||A_i||; the top-r eigenpairs of As^H As, scaled by
sqrt(eigenvalue), initialize the over-parameterized X.

For large n (= Nt*Nr up to ~1300) a full eigendecomposition is wasteful;
``method="subspace"`` uses fixed-trip orthogonal iteration for the
leading subspace only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .eigh_jacobi import eigh_desc, subspace_eigh


def spectral_initialize(a, b, r: int, method: str = "subspace",
                        eig_backend: str = "jacobi", key=None):
    """Return X0 of shape ``(n, r)``.

    ``a``: (m, n) complex sensing matrix; ``b``: (m,) magnitudes.
    """
    m, n = a.shape
    r = min(r, m, n)
    row_norm = jnp.linalg.norm(a, axis=-1)
    scale = jnp.where(row_norm > 0, b / jnp.maximum(row_norm, 1e-30), 1.0)
    a_s = a * scale[:, None].astype(a.dtype)
    g = jnp.conj(a_s.T) @ a_s
    g = 0.5 * (g + jnp.conj(g.T))
    if method == "subspace" and n > 4 * r:
        w, v = subspace_eigh(g, r, key=key)
    else:
        w, v = eigh_desc(g, backend=eig_backend)
        w, v = w[:r], v[:, :r]
    w = jnp.maximum(w, 0.0)
    return v * jnp.sqrt(w)[None, :].astype(a.dtype)


def random_initialize(key, shape, like):
    """init_mode = 0 path: uniform random scaled by max(Xs).

    ref: inferLowRankV4_multi.m:59-61.
    """
    mx = jnp.max(jnp.abs(like))
    return (jax.random.uniform(key, shape) * mx).astype(like.dtype)
