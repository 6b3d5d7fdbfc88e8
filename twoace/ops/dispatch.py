"""Solver dispatchers: the framework's equivalents of ``ADMM_v2`` and
``Recover_Channel`` / ``MyCPR``.

  - :func:`admm_v2` — version 0-4 dispatch
    (ref: main/src/my_recovery_algorithms/ADMM_v2.m:22-45; nuclear variant
    ADMM_v2_nuclear.m:32)
  - :func:`recover_channel` — testbed H-domain recovery over enabled methods
    with the exact PhaseLift/PLOMP scaling chains
    (ref: main/src/my_recovery_algorithms/Recover_Channel.m:1-47)
  - :func:`recover_sparse` — simulation-tree z-domain recovery over the full
    baseline family (ref: Numerical_Simulation/src/my_recovery_algorithms/
    MyCPR.m:74-190)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import (
    AdmmConfig,
    ArrayConfig,
    MethodFlags,
    PhaseLiftConfig,
    SpectralProfileConfig,
    TwoStageConfig,
)
from .admm import AdmmResult, solve_lowrank_multi, solve_minl2
from .cpr_baselines import conventional_cs, cprl, sparse_phaselift
from .gamp import prgamp
from .phaselift import phaselift_fista
from .twostage import two_stage_recovery

#: the reference's PhaseLift measurement scaling chain
#: (ref: Recover_Channel.m:35,41-44)
_PL_IN_SCALE = 2e5
_PL_LIFT_SCALE = 1e10


def admm_v2(key, measurements, beams, nt: int, nr: int, version: int = 4,
            cfg: AdmmConfig = AdmmConfig(), nuclear: bool = False,
            impl: str = "complex") -> AdmmResult:
    """Dispatch the ADMM solver family.

    ``measurements``: (m,) linear *amplitudes*; ``beams``: (m, nt*nr) probe
    rows.  version 0 = inferMinL2; 1/2/3 = historical single-restart ladders;
    4 = inferLowRankV4_multi (or inferLowRank_Nuclear when ``nuclear``).
    ref: ADMM_v2.m:22-45, ADMM_v2_nuclear.m:32.

    ``impl="pair"`` routes versions 1-4 through the pair-representation
    solver (:mod:`.pair_solver`), the production representation; results
    are returned as complex on the host.
    """
    b = jnp.real(jnp.asarray(measurements)).reshape(-1)
    a = jnp.asarray(beams)
    if version > 4 or version < 0:
        return _admm_v2_escalation(key, a, b, nt, nr, cfg, impl)
    if impl == "pair" and version != 0:
        from .cplx import Pair
        from .pair_solver import solve_lowrank_multi_pair

        ap = Pair(jnp.real(a).astype(jnp.float32),
                  jnp.imag(a).astype(jnp.float32))
        kwargs = dict(prox_kind="nuclear") if (version == 4 and nuclear) \
            else {}
        if version in (1, 2, 3):
            ladder = "v1" if version == 1 else "v2"
            cfg = dataclasses.replace(
                cfg, profile=dataclasses.replace(cfg.profile, ladder=ladder))
            kwargs["n_restarts"] = 1
        elif nuclear:
            kwargs["n_restarts"] = 1
        res = solve_lowrank_multi_pair(key, ap, b.astype(jnp.float32),
                                       nt, nr, cfg, **kwargs)
        # complex dtypes may not exist on the compute device (that is the
        # point of the pair path) — assemble the complex result on the host
        import numpy as np

        x = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
        return AdmmResult(x=x, y=np.asarray(a) @ x, quality=res.quality,
                          converged=res.converged)
    if version == 0:
        return solve_minl2(key, a, b, cfg)
    if version in (1, 2, 3):
        ladder = "v1" if version == 1 else "v2"
        cfg1 = dataclasses.replace(
            cfg, profile=dataclasses.replace(cfg.profile, ladder=ladder))
        return solve_lowrank_multi(key, a, b, nt, nr, cfg1, n_restarts=1)
    if version == 4:
        if nuclear:
            return solve_lowrank_multi(key, a, b, nt, nr, cfg,
                                       prox_kind="nuclear", n_restarts=1)
        return solve_lowrank_multi(key, a, b, nt, nr, cfg)
    raise ValueError(f"unknown ADMM version {version}")


def _admm_v2_escalation(key, a, b, nt: int, nr: int, cfg: AdmmConfig,
                        impl: str) -> AdmmResult:
    """The dispatcher's out-of-range escalation fallback (ADMM_v2.m:33-44):
    up to 3 retries of the V2 solver with growing parameters.

    Two quirks replicated faithfully from the reference:
      * the 6-positional call ``inferLowRankV2(A, B, TX, RX, RZ, R)``
        lands RZ in the LAMBDA slot and R in the width slot
        (inferLowRankV2.m:1), so the escalation actually grows the ridge
        weight (5, 7, 9) and the over-parameterization width
        (TX, TX + TX/2, ...), not a Z rank;
      * the loop breaks on ``if converged`` where "converged" is V2's
        third output — its QUALITY float (inferLowRankV2.m:1,42) — and
        MATLAB truthiness makes any nonzero quality "converged", so
        retries 2-3 are reachable only when quality == 0 exactly.

    Deviation (documented): the pair implementation's U precompute has no
    ridge hook, so ``impl="pair"`` escalates width only (lambda is a
    no-op there); the complex path folds lambda statically into U (see
    ops.admm._impl).
    """
    r_cur, lam_cur = nt, 5.0
    res = None
    for _ in range(3):
        cfg_i = dataclasses.replace(
            cfg, rank=r_cur, lam=lam_cur,
            profile=dataclasses.replace(cfg.profile, ladder="v2"))
        if impl == "pair":
            from .cplx import Pair
            from .pair_solver import solve_lowrank_multi_pair
            import numpy as np

            ap = Pair(jnp.real(a).astype(jnp.float32),
                      jnp.imag(a).astype(jnp.float32))
            rp = solve_lowrank_multi_pair(key, ap, b.astype(jnp.float32),
                                          nt, nr, cfg_i, n_restarts=1)
            x = np.asarray(rp.x.re) + 1j * np.asarray(rp.x.im)
            res = AdmmResult(x=x, y=np.asarray(a) @ x, quality=rp.quality,
                             converged=rp.converged)
        else:
            res = solve_lowrank_multi(key, a, b, nt, nr, cfg_i,
                                      n_restarts=1)
        if float(res.quality) != 0.0:
            break
        r_cur += nt // 2
        lam_cur += 2.0
    return res


def recover_channel(key, measurements, beams, flags: MethodFlags,
                    cfg: ArrayConfig, s: int, ad=None,
                    admm_cfg: AdmmConfig = AdmmConfig(),
                    pl_cfg: PhaseLiftConfig = PhaseLiftConfig(),
                    ts_cfg: TwoStageConfig = TwoStageConfig()
                    ) -> Dict[str, jax.Array]:
    """Run every enabled method; returns {method_name: vec_h estimate}.

    ref: Recover_Channel.m:1-47 (testbed tree) and Recover_Channel_nuclear.m.
    ``measurements`` are linear amplitudes as produced by
    :func:`twoace.utils.units.dbm_to_amplitude`.
    """
    out: Dict[str, jax.Array] = {}
    b = jnp.real(jnp.asarray(measurements)).reshape(-1)
    a = jnp.asarray(beams)

    version_map = {
        "admm": 0, "admm_lowrank_v1": 1, "admm_lowrank_v2": 2,
        "admm_lowrank_v3": 3, "admm_lowrank_v4": 4,
    }
    for name, version in version_map.items():
        if getattr(flags, name):
            out[name] = admm_v2(jax.random.fold_in(key, version), b, a,
                                cfg.nt, cfg.nr, version, admm_cfg).x
    if flags.admm_nuclear:
        out["admm_nuclear"] = admm_v2(jax.random.fold_in(key, 14), b, a,
                                      cfg.nt, cfg.nr, 4, admm_cfg,
                                      nuclear=True).x

    if flags.phaselift:
        # exact scaling chain (ref: Recover_Channel.m:35)
        intens = (b / _PL_IN_SCALE) ** 2 * _PL_LIFT_SCALE
        x = phaselift_fista(a, intens, pl_cfg).x
        out["phaselift"] = x / jnp.sqrt(_PL_LIFT_SCALE) * _PL_IN_SCALE

    if flags.plomp or flags.plgamp:
        if ad is None:
            raise ValueError("PLOMP/PLGAMP need the sparse dictionary AD")
        ad = jnp.asarray(ad, a.dtype)
        intens = (b / _PL_IN_SCALE) ** 2 * _PL_LIFT_SCALE
        ts = two_stage_recovery(intens, a @ ad, s, cfg=ts_cfg,
                                run_plomp=flags.plomp,
                                run_plgamp=flags.plgamp)
        scale = 1.0 / jnp.sqrt(_PL_LIFT_SCALE) * _PL_IN_SCALE
        if flags.plomp:
            out["plomp"] = (ad @ ts.plomp) * scale
        if flags.plgamp:
            out["plgamp"] = (ad @ ts.plgamp) * scale
    return out


def recover_channel_bf(key, measurements, beams, flags: MethodFlags,
                       cfg: ArrayConfig, recovered: Dict[str, jax.Array],
                       admm_cfg: AdmmConfig = AdmmConfig()
                       ) -> Dict[str, jax.Array]:
    """Beamforming-time re-recovery dispatcher (ref: Recover_Channel_bf.m:1-45).

    Re-runs only the (fast) ADMM variants on the fresh beamforming-phase
    measurements; the expensive lifted methods — PhaseLift / PLOMP /
    PLGAMP — are *passed through* from ``recovered``, the estimates of an
    earlier :func:`recover_channel` call (ref: Recover_Channel_bf.m:32-44,
    where H.PhaseLift = recovered_H.PhaseLift instead of re-solving).
    """
    out: Dict[str, jax.Array] = {}
    b = jnp.real(jnp.asarray(measurements)).reshape(-1)
    a = jnp.asarray(beams)

    version_map = {
        "admm": 0, "admm_lowrank_v1": 1, "admm_lowrank_v2": 2,
        "admm_lowrank_v3": 3, "admm_lowrank_v4": 4,
    }
    for name, version in version_map.items():
        if getattr(flags, name):
            out[name] = admm_v2(jax.random.fold_in(key, version), b, a,
                                cfg.nt, cfg.nr, version, admm_cfg).x
    if flags.admm_nuclear:
        out["admm_nuclear"] = admm_v2(jax.random.fold_in(key, 14), b, a,
                                      cfg.nt, cfg.nr, 4, admm_cfg,
                                      nuclear=True).x
    for passthrough in ("phaselift", "plomp", "plgamp"):
        if getattr(flags, passthrough):
            if passthrough not in recovered:
                raise ValueError(
                    f"{passthrough} enabled but absent from `recovered`; "
                    "Recover_Channel_bf reuses earlier estimates for the "
                    "lifted methods")
            out[passthrough] = recovered[passthrough]
    return out


def recover_sparse(key, measurements, measurement_mat, flags: MethodFlags,
                   s: int, noise_power: float = 1.0,
                   measurements_perfect=None, measurements_noisy=None,
                   pl_cfg: PhaseLiftConfig = PhaseLiftConfig(),
                   ts_cfg: TwoStageConfig = TwoStageConfig()
                   ) -> Dict[str, jax.Array]:
    """Simulation-tree dispatcher over the sparse (z-domain) baselines.

    ``measurements``: (m,) intensities |y|^2; ``measurement_mat``: (m, P) =
    FW @ AD.  ref: MyCPR.m:74-190 (PhaseLift/CPRL/PRGAMP/SparsePL/
    PLOMP/PLGAMP + perfect/noisy-phase conventional CS).
    """
    out: Dict[str, jax.Array] = {}
    b2 = jnp.real(jnp.asarray(measurements)).reshape(-1)
    a = jnp.asarray(measurement_mat)

    if flags.phaselift:
        out["phaselift"] = phaselift_fista(a, b2, pl_cfg).x
    if flags.cprl:
        out["cprl"] = cprl(b2, a)
    if flags.prgamp:
        out["prgamp"] = prgamp(jnp.sqrt(b2), a)
    if flags.sparse_pl:
        out["sparse_pl"] = sparse_phaselift(b2, a, cfg=pl_cfg)
    if flags.plomp or flags.plgamp:
        ts = two_stage_recovery(b2, a, s, noise_power, ts_cfg,
                                run_plomp=flags.plomp,
                                run_plgamp=flags.plgamp)
        if flags.plomp:
            out["plomp"] = ts.plomp
        if flags.plgamp:
            out["plgamp"] = ts.plgamp
    if measurements_perfect is not None:
        out["perfect_phase_cs"] = conventional_cs(
            jnp.asarray(measurements_perfect).reshape(-1), a, s, noise_power)
    if measurements_noisy is not None:
        out["noisy_phase_cs"] = conventional_cs(
            jnp.asarray(measurements_noisy).reshape(-1), a, s, noise_power)
    return out
