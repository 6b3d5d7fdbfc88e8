"""Two-stage compressive phase retrieval: PLOMP and PLGAMP.

JAX rewrite of ``My_TwoStage_Recovery``
(ref: main/src/my_recovery_algorithms/My_TwoStage_Recovery.m:75-182):

  1. SVD-compress the sensing matrix ``A = P C`` keeping ``mCS`` directions
     (ref :81-100);
  2. stage 1: PhaseLift on ``P`` recovers the compressed vector up to global
     phase (ref :117-153);
  3. stage 2: OMP (PLOMP) or Bernoulli-Gaussian GAMP (PLGAMP) solves the
     sparse system ``C z = intermediate`` (ref :156-181).

Static-shape note: the reference grows ``mCS`` data-dependently until the
captured SVD energy reaches 0.8 *and* ``1.75 mCS log mCS >= m``; the second
(m-only) bound dominates in the regimes the paper uses, so we take the
static value ``mCS = min(m, n, min{k: 1.75 k log k >= m})`` to keep one
compiled program per shape (documented deviation).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import PhaseLiftConfig, TwoStageConfig
from .gamp import embgamp
from .omp import omp
from .phaselift import phaselift_fista


class TwoStageResult(NamedTuple):
    plomp: jax.Array     #: (n,) sparse recovery via OMP stage 2
    plgamp: jax.Array    #: (n,) sparse recovery via GAMP stage 2
    compressed: jax.Array  #: (mcs,) stage-1 intermediate solution


def static_mcs(m: int, n: int, s: int, cfg: TwoStageConfig) -> int:
    """The m-driven compression size (see module docstring)."""
    lo = max(2, round(cfg.cs_oversample * s * math.log(max(n / max(s, 1), 2))))
    k = max(2, min(lo, min(m, n)) - 1)
    while round(cfg.cs_oversample * k * math.log(max(k, 2))) < m \
            and k < min(m, n):
        k += 1
    return k


def adaptive_mcs(singular_values, m: int, n: int, s: int,
                 cfg: TwoStageConfig) -> int:
    """The reference's exact data-dependent mCS rules (host-side).

    ref: My_TwoStage_Recovery.m:79-95 — start near 1.75*s*log(n/s), grow
    until the captured singular-value mass reaches ``energy_threshold``, then
    grow further while 1.75*mCS*log(mCS) < m.
    """
    import numpy as np

    ds = np.asarray(singular_values)
    total = float(ds.sum())
    k_max = len(ds)
    lo = round(cfg.cs_oversample * s * math.log(max(n / max(s, 1), 2)))
    k = max(1, min(lo, k_max) - 1)
    while float(ds[:k].sum()) < cfg.energy_threshold * total and k < k_max:
        k += 1
    while round(cfg.cs_oversample * k * math.log(max(k, 2))) < m and k < k_max:
        k += 1
    return k


def two_stage_recovery(measurements, a, s: int,
                       noise_power: float = 1.0,
                       cfg: TwoStageConfig = TwoStageConfig(),
                       run_plomp: bool = True, run_plgamp: bool = True,
                       mcs: Optional[int] = None) -> TwoStageResult:
    """``measurements``: (m,) intensities |y|^2; ``a``: (m, n) measurement
    matrix (already FW @ AD); ``s``: sparsity level (number of paths).

    The compression size mCS is chosen host-side with the reference's exact
    data-dependent rules (:func:`adaptive_mcs`); the rest runs as one jitted
    program per (shape, mCS).
    """
    if mcs is None:
        sv_host = jnp.linalg.svd(jnp.asarray(a), compute_uv=False)
        mcs = adaptive_mcs(sv_host, a.shape[0], a.shape[1], s, cfg)
    return _two_stage_jit(measurements, a, s, noise_power, cfg, run_plomp,
                          run_plgamp, mcs)


@partial(jax.jit, static_argnames=("s", "cfg", "run_plomp", "run_plgamp",
                                   "mcs"))
def _two_stage_jit(measurements, a, s: int,
                   noise_power: float,
                   cfg: TwoStageConfig,
                   run_plomp: bool, run_plgamp: bool,
                   mcs: int) -> TwoStageResult:
    m, n = a.shape
    k = mcs

    # SVD split A = P C (ref :81-100).  Thin SVD via the smaller Gram.
    u, sv, vh = jnp.linalg.svd(a, full_matrices=False)
    u, sv, vh = u[:, :k], sv[:k], vh[:k, :]
    root = jnp.sqrt(sv).astype(a.dtype)
    p = u * root[None, :]
    c = root[:, None] * vh

    # stage 1: PhaseLift on P (ref :117-153)
    pl = phaselift_fista(p, jnp.real(measurements), cfg.phaselift)
    int_soln = pl.x

    # stage 2 (ref :156-181).  The OMP solve doubles as PLGAMP's divergence
    # fallback, so it is computed whenever either stage-2 method runs.
    if run_plomp or run_plgamp:
        omp_soln = omp(c, int_soln, max_steps=max(2 * s, 4))
    plomp = omp_soln if run_plomp else jnp.zeros((n,), a.dtype)
    if run_plgamp:
        snr_db = 10.0 * jnp.log10(1.0 / jnp.maximum(noise_power, 1e-20))
        raw = embgamp(int_soln, c, snr_db, lam0=s / n,
                      learn_lambda=False)
        # EMBGAMP -> OMP fallback (ref: My_TwoStage_Recovery.m:173-178
        # wraps EMBGAMP in try/catch and answers OMP(A_Gamp, intSoln_PL)
        # on failure, so the reference's PLGAMP curve is always finite).
        # Under jit the divergence manifests as non-finite output or as a
        # collapsed iterate whose residual is ~||int_soln|| (the zero
        # fixed point) — route only those to the already-computed OMP
        # solution.  NOT a fit-vs-OMP comparison: OMP's LS refit
        # generically out-fits GAMP's MMSE-shrunk estimate even when
        # GAMP's recovery is better (see cpr_baselines.conventional_cs).
        #
        # The stage-2 "noise" is the stage-1 PhaseLift error, which has no
        # a-priori power, so the noise floor of the collapse test is
        # estimated from the achievable residual: OMP's LS-refit residual
        # is close to the best any s-sparse fit attains here, and a GAMP
        # residual within 2x of it (4x in power) is a healthy fit even
        # when ||int_soln|| itself is mostly stage-1 error (low SNR) — a
        # plain 0.9*||int_soln|| cut would mislabel that regime collapse.
        finite = jnp.all(jnp.isfinite(raw.real) & jnp.isfinite(raw.imag))
        raw_safe = jnp.where(jnp.isfinite(raw.real) & jnp.isfinite(raw.imag),
                             raw, 0.0)
        r2_gamp = jnp.sum(jnp.abs(int_soln - c @ raw_safe) ** 2)
        r2_omp = jnp.sum(jnp.abs(int_soln - c @ omp_soln) ** 2)
        floor2 = jnp.maximum(0.81 * jnp.sum(jnp.abs(int_soln) ** 2),
                             4.0 * r2_omp)
        ok = jnp.logical_and(finite, r2_gamp < floor2)
        plgamp = jnp.where(ok, raw, omp_soln)
    else:
        plgamp = jnp.zeros((n,), a.dtype)
    return TwoStageResult(plomp=plomp, plgamp=plgamp, compressed=int_soln)
