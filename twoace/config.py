"""Configuration dataclasses for the 2ACE framework.

Replaces the copy-pasted MATLAB config blocks of the reference:
  - the ``ULA`` struct (ref: main/channel_recovery_ADMM_v2_simulation_A2only.m:40-46)
  - the solver kwargs with ``nargin`` defaults
    (ref: main/src/my_recovery_algorithms/ADMM_v2/inferLowRankV4_multi.m:6-15)
  - the ``Method`` enable-flag struct (ref: A2only.m:66-101)

All configs are frozen dataclasses so they are hashable and can be passed as
static arguments to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

SPEED_OF_LIGHT = 3.0e8
#: 60.48 GHz carrier (ref: A2only.m:40)
DEFAULT_CARRIER_HZ = 60.48e9
#: wavelength of the 60.48 GHz carrier
DEFAULT_LAMBDA = SPEED_OF_LIGHT / DEFAULT_CARRIER_HZ
#: antenna spacing of the QCA6310 URA (ref: A2only.m:41)
DEFAULT_SPACING = 3.055e-3
#: RSS multiplicative factor moving amplitudes near 1 (ref: A2only.m:132)
DEFAULT_RSS_FCT = 1e5 / 3.0

#: Fixed seed table of the MATLAB entry points (ref: A2only.m:103).  We keep the
#: same table so ``seed_id`` indices mean the same experiment in both stacks
#: (the PRNG streams themselves differ: JAX threefry vs MATLAB twister).
SEED_TABLE: Tuple[int, ...] = (
    58659179, 42737934, 36326041, 89830260, 90710947, 96474890, 33424536,
    67991541, 42149446, 38961924, 54659060, 32629256, 33087755, 27433950,
    9404442, 20146383, 84040563, 75325961, 47726929, 13999319, 5597853,
    74801351, 37024073, 75534492, 99245881, 19650488, 5314224, 98859252,
    60803022, 76056701, 14112116, 64027813, 73073690, 6288587, 42217659,
    45632040, 7495955, 31960297, 92863244, 93081516,
)


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Uniform linear/rectangular array geometry (the reference's ``ULA`` struct).

    ref: main/channel_recovery_ADMM_v2_simulation_A2only.m:40-46
    """

    nt: int = 16                      #: number of Tx antennas
    nr: int = 16                      #: number of Rx antennas
    wavelength: float = DEFAULT_LAMBDA
    spacing: float = DEFAULT_SPACING  #: element spacing d
    phase_bit: int = 2                #: phase-shifter resolution in bits
    nqt: Optional[int] = None         #: AoD grid size (default 4*nt, ref :45)
    nqr: Optional[int] = None         #: AoA grid size (default 4*nr, ref :46)

    @property
    def n(self) -> int:
        return self.nt * self.nr

    @property
    def grid_t(self) -> int:
        return 4 * self.nt if self.nqt is None else self.nqt

    @property
    def grid_r(self) -> int:
        return 4 * self.nr if self.nqr is None else self.nqr

    @property
    def k_d(self) -> float:
        """2*pi*d/lambda, the spatial frequency scale."""
        import math

        return 2.0 * math.pi * self.spacing / self.wavelength


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Synthetic sparse-multipath channel parameters (Eq. 23 model).

    ref: main/src/generate_channel/Generate_Channel.m:64-164 and the entry
    config block A2only.m:52-64.
    """

    n_paths: int = 3                 #: L, number of dominant paths
    searching_area_deg: float = 95.0 #: AoD/AoA range (ref A2only.m:52)
    rician_k: int = 5                #: number of NLOS paths when L == 1
    k_factor_db: float = 7.0         #: Rician K-factor (ref Generate_Channel.m:151)
    on_grid: bool = False            #: snap AoD/AoA to the virtual grid
    fix_angles: bool = False         #: debug mode with fixed angles


@dataclasses.dataclass(frozen=True)
class SpectralProfileConfig:
    """The 2ACE spectral-profile (power-law) constraint ladder.

    ref: inferLowRankV4_multi.m:437-464 (ArgMinZ).  ``ladder`` selects between
    the historical solver generations:
      - ``"v1"``: single constraint (ceil(sqrt(sz)), 0.95)
        (ref: inferLowRank.m:407-418)
      - ``"v4"``: the full 4-level ladder with small-size fallbacks
        (ref: inferLowRankV4_multi.m:437-464)
    """

    ladder: str = "v4"
    #: rank multipliers of the ladder r_k = ceil(sqrt(sz) * mult)
    rank_mults: Tuple[float, ...] = (0.5, 0.7, 1.0, 2.0)
    #: variance fractions f_k of the ladder
    fractions: Tuple[float, ...] = (0.8, 0.9, 0.95, 0.995)


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """2ACE ADMM solver hyper-parameters.

    Defaults mirror inferLowRankV4_multi.m:6-15.
    """

    lam: float = 0.0          #: ridge weight lambda
    rank: int = 20            #: over-parameterization width r
    mu0: float = 1e-3         #: initial augmented-Lagrangian weight
    rho: float = 1.03         #: mu adaptation multiplier
    cc_frac: float = 0.95     #: train fraction of the internal split
    tol_rel: float = 1e-4
    tol_abs: float = 1e-8
    maxiter: int = 500
    n_restarts: int = 3       #: restarts (ref :42)
    quality_threshold: float = 0.6   #: rank-1 retry / rollback gate (ref :73,89)
    similarity_threshold: float = 0.6  #: refinement rollback gate (ref :94)
    spectral_init: bool = True       #: init_mode (ref :14)
    prox: str = "spectral_profile"   #: "spectral_profile" | "nuclear" | "none"
    profile: SpectralProfileConfig = SpectralProfileConfig()
    #: JAX matmul precision for the solver body, applied at trace time.
    #: "float32" (the default) is HIGHEST: on an H100 every f32 product
    #: runs as true FP32 on the CUDA cores (67 TFLOP/s data-sheet peak),
    #: bit-for-bit the arithmetic of the float64 reference rounded to f32,
    #: so the residual convergence tests fire and the iterates reach the
    #: float32 floor.  "default" lets XLA pick the backend default, which
    #: on an H100 is a TF32 tensor-core product (10-bit mantissa, 495
    #: TFLOP/s peak).  ``chip_smoke.py`` measures both on the card: on one
    #: H100 80GB HBM3 at 700 W, 50 inner-ADMM iterations at 16x16 left x
    #: 4.9e-5 (relative) off the float64 reference under "float32" and
    #: 1.6e-2 under "default"; the 16x16 batch reached a median NMSE of
    #: -112.0 dB cold and -110.0 dB with an 80-iteration TF32 warm phase.
    #: On the CPU both are exact f32.
    #: Which one each workload should use is ROADMAP A2.
    matmul_precision: str = "float32"
    #: Mixed-precision warm phase: run the FIRST ``warm_iters`` iterations
    #: of each FIRST-PASS inner ADMM solve (the restart solves of the
    #: single-device scaffolds AND of the row-sharded scaffold) at the
    #: backend's "default" matmul precision (TF32 on an H100), then hand
    #: the carried state to the float32 tail that actually converges.
    #: Refinement-stage solves are deliberately EXCLUDED: they start from
    #: an already-converged x, which coarse iterations would degrade
    #: before the tail re-converges it (the warm-started tracking refine
    #: applies it explicitly, refine_lowrank_pair).  0 disables (pure
    #: ``matmul_precision`` throughout); no effect on CPU (f32 is exact
    #: there).
    #:
    #: ACCURACY CONTRACT.  Reference parity is judged at +-0.5 dB around
    #: roughly -60 dB (test_parity.py), the campaign artifacts live above
    #: -30 dB, and the quality/rollback gates compare magnitude-domain
    #: residuals of order 0.1-0.4; the warm schedule must keep the median
    #: solution below -60 dB NMSE, which ``chip_smoke.py`` checks on the
    #: card.  Entry-point defaults: library solvers and campaign CLIs
    #: default to 0 (cold, full precision end to end); only bench.py
    #: passes warm_iters=80 explicitly.
    warm_iters: int = 0
    #: Iteration cap for the FIRST (over-parameterized, scale_by_row) pass
    #: of each inferLowRankImpl solve.  The reference runs both passes to
    #: full tolerance (inferLowRankV4_multi.m:241,265) but the second pass
    #: re-converges from the orthonormalized first-pass state anyway, so
    #: most of pass 1's tail iterations are re-done work.  None = full
    #: cfg.maxiter (reference semantics, the default); an int trades
    #: pass-1 tail iterations for batch throughput (bench.py uses 120).
    stage1_maxiter: Optional[int] = None
    #: Iteration cap for the SECOND (per-column, scale_by_row=False) pass.
    #: Under the batch solver's instance vmap the pass-2 while_loop runs
    #: every lane to the SLOWEST lane's trip count; a cap near the p90 of
    #: the trip distribution (bench.py uses 160) bounds the straggler
    #: without touching typical lanes, and the full-data refinement stage
    #: (which runs at full cfg.maxiter) re-converges the selected restart
    #: anyway.  None = full cfg.maxiter (reference semantics, the default).
    stage2_maxiter: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PhaseLiftConfig:
    """PhaseLift trace-regularized SDP solver parameters.

    ref: main/src/my_recovery_algorithms/MyPhaseLift.m:83-101.
    """

    lam: float = 5e-2        #: trace regularization weight
    max_iters: int = 4000
    tol: float = 1e-10
    restart_every: int = 200
    #: "fista" = exact lifted FISTA w/ PSD projection; "bm" = Burer-Monteiro
    method: str = "fista"
    bm_rank: int = 8         #: factor rank for the Burer-Monteiro path


@dataclasses.dataclass(frozen=True)
class TwoStageConfig:
    """Two-stage PLOMP/PLGAMP compressive phase-retrieval parameters.

    ref: main/src/my_recovery_algorithms/My_TwoStage_Recovery.m:75-100.
    """

    energy_threshold: float = 0.80   #: SVD energy capture (ref :86)
    cs_oversample: float = 1.75      #: mCS = round(1.75*s*log(n/s)) (ref :79)
    phaselift: PhaseLiftConfig = PhaseLiftConfig()


@dataclasses.dataclass(frozen=True)
class MethodFlags:
    """Which recovery algorithms to run (the reference's ``Method`` struct).

    ref: A2only.m:66-101, Recover_Channel.m:3-45.
    """

    phaselift: bool = False
    cprl: bool = False
    prgamp: bool = False
    sparse_pl: bool = False
    plomp: bool = False
    plgamp: bool = False
    admm: bool = False            #: version 0 (inferMinL2)
    admm_lowrank_v1: bool = False
    admm_lowrank_v2: bool = False
    admm_lowrank_v3: bool = False
    admm_lowrank_v4: bool = True  #: the 2ACE "A2" solver
    admm_nuclear: bool = False

    def enabled(self):
        return [f.name for f in dataclasses.fields(self) if getattr(self, f.name)]


def probe_budget_grid(nt: int, nr: int, num: int = 8) -> Tuple[int, ...]:
    """The M grid ``round(linspace(2, sqrt(4*Nt*Nr), num)).^2``.

    ref: A2only.m:106-118.  For 16x16 this yields
    (4, 36, 121, 225, 361, 529, 784, 1024).
    """
    import numpy as np

    lin = np.linspace(2.0, np.sqrt(4.0 * nt * nr), num)
    # MATLAB round() rounds halves away from zero; np.round rounds to even.
    return tuple(int(np.floor(x + 0.5)) ** 2 for x in lin)


#: multi-resolution tier thresholds + row offsets for the 16-antenna codebook
#: (ref: channel_recovery_ADMM_v2_simulation_multiresolution.m:111-112)
MULTIRES_THRESHOLDS: Tuple[int, int] = (96, 256)
MULTIRES_SEPARATION: Tuple[int, int, int] = (1984, 3968, 3968)
