"""Batched complex-Hermitian eigensolvers for small matrices.

The 2ACE spectral-profile prox needs an eigendecomposition of a tiny
(Nr x Nr, Nr <= 36) PSD Gram matrix *inside* the jitted ADMM loop
(ref: main/src/my_recovery_algorithms/ADMM_v2/inferLowRankV4_multi.m:428-430).
``jnp.linalg.eigh`` is a general-purpose library path; here we use a
parallel-ordered cyclic Jacobi iteration whose inner step is two small
matmuls and which vmaps cleanly over batch axes (which of the two wins on
a GPU is ROADMAP A5).

Also provides ``subspace_eigh`` (orthogonal iteration) for the top-r
eigenpairs of large Gram matrices, used by the spectral initialization
(ref: inferLowRankV4_multi.m:561-574) where n = Nt*Nr can reach ~1300 and a
full eigendecomposition is wasteful.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def _round_robin_pairs(n: int):
    """Static round-robin tournament schedule: (n-1) rounds of n//2 disjoint
    (p, q) pairs covering all index pairs once per sweep."""
    m = n if n % 2 == 0 else n + 1        # pad with a bye for odd n
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        if pairs:
            rounds.append(np.asarray(pairs, np.int32).reshape(-1, 2))
        # rotate all but the first player
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _rotation_matrix(a, p_idx, q_idx, eps):
    """Build the block unitary G of disjoint complex Givens rotations that
    annihilate a[p, q] for each (p, q) pair under G^H a G.

    Works for complex-Hermitian and real-symmetric ``a`` alike (for real
    dtypes the phase factor degenerates to the sign and conj is a no-op) —
    the real path is what the pair-representation pipeline uses.
    """
    n = a.shape[-1]
    app = jnp.real(a[..., p_idx, p_idx])           # (..., k)
    aqq = jnp.real(a[..., q_idx, q_idx])
    apq = a[..., p_idx, q_idx]
    r = jnp.abs(apq)
    # phase of the off-diagonal element; identity rotation when negligible
    safe_r = jnp.maximum(r, eps)
    phi = apq / safe_r
    tau = (aqq - app) / (2.0 * safe_r)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(r > eps, t, 0.0)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = (t * c).astype(a.dtype) * phi              # complex (or signed) sine

    g = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    cc = c.astype(a.dtype)
    # columns p, q of G: G[:, p] = c e_p - conj(s) e_q ; G[:, q] = s e_p + c e_q
    g = g.at[..., p_idx, p_idx].set(cc)
    g = g.at[..., q_idx, q_idx].set(cc)
    g = g.at[..., q_idx, p_idx].set(-jnp.conj(s))
    g = g.at[..., p_idx, q_idx].set(s)
    return g


def eigh_jacobi(a, sweeps: int = 8, eps: float = 1e-30):
    """Eigendecomposition of a batched Hermitian (or real symmetric) matrix
    ``(..., n, n)``.

    Returns ``(w, v)`` with eigenvalues **descending** and
    ``a ~= v @ diag(w) @ v^H``.  Fixed trip count (``sweeps`` full cyclic
    sweeps) so the computation is a static XLA graph; quadratic convergence
    makes 8 sweeps machine-precision for n <= 64.  Real inputs stay real
    throughout (the pair-representation path).
    """
    a = jnp.asarray(a)
    n = a.shape[-1]
    if n == 1:
        w = jnp.real(a[..., 0, 0])[..., None]
        v = jnp.ones(a.shape, a.dtype)
        return w, v
    # (n-1 rounds, pairs per round, 2): every round has the same number of
    # disjoint pairs, so the rounds are scanned, not unrolled; unrolled,
    # each call puts n-1 copies of the rotation into the solver graph, and
    # those copies dominate the solvers' compile time
    schedule = jnp.asarray(np.stack(_round_robin_pairs(n)))

    v = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)

    def rotate(carry, pairs):
        a, v = carry
        g = _rotation_matrix(a, pairs[:, 0], pairs[:, 1], eps)
        gh = jnp.conj(jnp.swapaxes(g, -1, -2))
        return (gh @ a @ g, v @ g), None

    def sweep(carry, _):
        return jax.lax.scan(rotate, carry, schedule)[0], None

    (a, v), _ = jax.lax.scan(sweep, (a, v), None, length=sweeps)
    w = jnp.real(jnp.diagonal(a, axis1=-2, axis2=-1))
    order = jnp.argsort(-w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    v = jnp.take_along_axis(v, order[..., None, :], axis=-1)
    return w, v


def eigh_desc(a, backend: str = "jacobi", sweeps: int = 8):
    """Hermitian eigendecomposition with eigenvalues sorted descending.

    backend "jacobi" uses :func:`eigh_jacobi` (fixed cost, vmaps cleanly);
    backend "xla" defers to ``jnp.linalg.eigh``.
    """
    if backend == "xla":
        w, v = jnp.linalg.eigh(a)
        order = jnp.argsort(-w, axis=-1)
        w = jnp.take_along_axis(w, order, axis=-1)
        v = jnp.take_along_axis(v, order[..., None, :], axis=-1)
        return w, v
    return eigh_jacobi(a, sweeps=sweeps)


def subspace_eigh(g, k: int, iters: int = 24, key=None):
    """Top-``k`` eigenpairs of a batched Hermitian PSD ``g`` ``(..., n, n)``
    by orthogonal (subspace) iteration with a fixed trip count.

    Used for spectral initialization where only the leading subspace matters
    (ref: inferLowRankV4_multi.m:561-574).  Returns ``(w, v)`` descending.
    """
    g = jnp.asarray(g)
    n = g.shape[-1]
    k = min(k, n)
    if key is None:
        key = jax.random.PRNGKey(17)
    q = jax.random.normal(key, g.shape[:-2] + (n, 2 * k), jnp.float32) \
        .astype(g.dtype)

    def body(q, _):
        z = g @ q
        q, _ = jnp.linalg.qr(z)
        return q, None

    q, _ = jax.lax.scan(body, q, None, length=iters)
    # Rayleigh-Ritz on the subspace
    r = jnp.conj(jnp.swapaxes(q, -1, -2)) @ (g @ q)
    r = 0.5 * (r + jnp.conj(jnp.swapaxes(r, -1, -2)))
    w, s = eigh_jacobi(r)
    v = q @ s
    return w[..., :k], v[..., :k]
