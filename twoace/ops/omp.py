"""Orthogonal Matching Pursuit, jit/batch-friendly.

Replaces the vendored CoSaMP_OMP toolbox ``OMP()`` used by the two-stage
PLOMP recovery and the conventional-CS fallback
(ref: main/src/my_recovery_algorithms/My_TwoStage_Recovery.m:156-161,
 My_Conventional_CS.m:14-30).

Design: fixed trip count with a support *mask* instead of dynamic
index sets; each step is one masked normal-equation solve (n x n) — static
shapes throughout, so the whole pursuit jits and vmaps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("max_steps",))
def omp(a, y, max_steps: int, tol: float = 1e-12):
    """Solve ``y ~= A x`` with at most ``max_steps`` nonzeros.

    ``a``: (m, n); ``y``: (m,).  Returns dense ``x`` (n,) with zeros off the
    selected support.  Stops growing the support once the residual norm drops
    below ``tol * ||y||`` (steps keep running with a frozen state — fixed
    trip count for jit).
    """
    m, n = a.shape
    gram = jnp.conj(a.T) @ a                     # (n, n)
    aty = jnp.conj(a.T) @ y
    ynorm = jnp.linalg.norm(y)

    def solve_masked(mask):
        """LS over masked columns via regularized masked normal equations."""
        gm = gram * jnp.outer(mask, mask).astype(gram.dtype) \
            + jnp.diag((1.0 - mask).astype(gram.dtype))
        rhs = aty * mask.astype(aty.dtype)
        return jnp.linalg.solve(gm, rhs) * mask.astype(aty.dtype)

    def body(carry, _):
        mask, x, resid, done = carry
        corr = jnp.abs(jnp.conj(a.T) @ resid)
        corr = jnp.where(mask > 0, -jnp.inf, corr)
        j = jnp.argmax(corr)
        mask_new = jnp.where(done, mask, mask.at[j].set(1.0))
        x_new = solve_masked(mask_new)
        resid_new = y - a @ x_new
        done_new = jnp.logical_or(done,
                                  jnp.linalg.norm(resid_new) < tol * ynorm)
        return (mask_new, x_new, resid_new, done_new), None

    mask0 = jnp.zeros((n,))
    x0 = jnp.zeros((n,), a.dtype)
    (mask, x, resid, _), _ = lax.scan(
        body, (mask0, x0, y, jnp.asarray(False)), None,
        length=min(max_steps, m, n))
    return x
