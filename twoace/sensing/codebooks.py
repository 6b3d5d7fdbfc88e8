"""Codebook generation — the JAX replacement of the reference's L1
hardware/codebook layer.

The reference emits opaque ``.brd`` images via a closed-source binary and
parses text phase tables back (ref: codebook/generate_rx_codebook_*.py,
codebook/processsing_codebook_*.m).  Here a codebook is just data: integer
phase *bits* (2-bit by default) plus an amplitude mask, and pure functions
that compile them into complex beamforming rows / full kron probe matrices.

Families implemented (ref file for each):
  - random per-round codebooks          (generate_rx_codebook_16ant_random.py:44-92)
  - multi-resolution 3-tier codebooks   (generate_rx_codebook_multires_16ant.py:47-144)
  - directional / angular-uniform beams (Directional_Beam{_Angular}.m)
  - azimuth sweep codebooks             (generate codebook "sweeping_phi" family)
  - ACO per-antenna phase-sweep masks   (generate_rx_codebook_16ant_ACO.py)
  - kron probe assembly                 (processsing_codebook_random.m:54-62,
                                         processsing_codebook_multires.m:60-61)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ArrayConfig
from ..models.steering import dictionary, steering_vector, virtual_grid
from ..utils.metrics import quantize_ps


class Codebook(NamedTuple):
    """A phase-bit codebook: the framework's replacement for ``.brd`` images."""

    bits: jax.Array              #: (entries, n_ant) integer phase bits
    amp: jax.Array               #: (n_ant,) 0/1 amplitude mask
    phase_bit: int = 2
    #: optional per-antenna calibration bits already folded into ``bits``
    #: ("actual" table); None means bits are the ideal/"inferred" table.
    calibration: Optional[np.ndarray] = None

    @property
    def n_ant(self) -> int:
        return self.bits.shape[-1]

    def rows(self, normalize: bool = False) -> jax.Array:
        """Complex beamforming rows ``amp * exp(1j * bits * 2pi/2^b)``.

        ref: processsing_codebook_random.m:48-51.  ``normalize`` divides by
        sqrt(n_active) (sensing-matrix convention).
        """
        nps = 2 ** self.phase_bit
        w = self.amp * jnp.exp(1j * self.bits * (2.0 * np.pi / nps))
        if normalize:
            w = w / jnp.sqrt(jnp.maximum(jnp.sum(self.amp), 1))
        return w


# --------------------------------------------------------------- random family

def random_phase_bits(key, m: int, n: int, phase_bit: int = 2,
                      prefix_stable: bool = True) -> jax.Array:
    """Uniform random phase bits ``(m, n)``.

    ``prefix_stable=True`` draws each row from a fold_in'd key so that the
    first M rows are identical for any larger m — the nesting property the
    reference gets by drawing measurements incrementally
    (ref: Generate_Sensing_Matrix.m:86-99).
    """
    nps = 2 ** phase_bit
    if prefix_stable:
        def row(i):
            return jax.random.randint(jax.random.fold_in(key, i), (n,), 0, nps)
        return jax.vmap(row)(jnp.arange(m))
    return jax.random.randint(key, (m, n), 0, nps)


def random_codebook(key, entries: int, n_ant: int,
                    phase_bit: int = 2) -> Codebook:
    """Per-round random 2-bit codebook (ref: generate_rx_codebook_16ant_random.py)."""
    bits = random_phase_bits(key, entries, n_ant, phase_bit)
    return Codebook(bits=bits, amp=jnp.ones((n_ant,)), phase_bit=phase_bit)


def random_sensing_rows(key, m: int, n: int, phase_bit: int = 2) -> jax.Array:
    """Random phase-state sensing rows ``exp(1j b 2pi/Np)/sqrt(n)``.

    The ``Random_Phase_State`` mode draws the full (Nt*Nr)-length row directly
    (ref: Generate_Sensing_Matrix.m:110-118), not a Tx x Rx kron.
    """
    nps = 2 ** phase_bit
    bits = random_phase_bits(key, m, n, phase_bit)
    return jnp.exp(1j * bits * (2.0 * np.pi / nps)) / math.sqrt(n)


# ---------------------------------------------------------- directional family

def directional_beams_angular(mt: int, mr: int, cfg: ArrayConfig,
                              aod_range: Tuple[float, float],
                              aoa_range: Tuple[float, float]):
    """Directional beams uniform in *angle*: Mt/Mr sector centers, 2-bit
    quantized.  Returns ``(F (nt, mt), W (nr, mr))``.
    ref: Directional_Beam_Angular.m:65-86.
    """
    def centers(rng, m):
        edges = np.linspace(rng[0], rng[1], m + 1)
        return (edges[:-1] + edges[1:]) / 2.0

    aod = jnp.asarray(centers(aod_range, mt))
    aoa = jnp.asarray(centers(aoa_range, mr))
    f = steering_vector(jnp.sin(jnp.deg2rad(aod)), cfg.nt, cfg.k_d).T
    w = steering_vector(jnp.sin(jnp.deg2rad(aoa)), cfg.nr, cfg.k_d).T
    return quantize_ps(f, cfg.phase_bit), quantize_ps(w, cfg.phase_bit)


def directional_beams_spatial(mt: int, mr: int, cfg: ArrayConfig,
                              searching_area_deg: float,
                              oversample: int = 20,
                              small_gain: float = 0.05,
                              rank_eliminated: int = 0,
                              key=None):
    """Directional beams with uniform gain in *spatial (sin) domain*:
    boxcar beam-space targets with overlap, least-squares mapped to antenna
    weights, then 2-bit quantized.  ref: Directional_Beam.m:69-167.

    ``rank_eliminated`` (ref: Directional_Beam.m:56-57,84-88,169-178)
    lowers the rank of F/W for the two-stage PLOMP/PLGAMP pipeline: only
    ``Mt - rank_eliminated`` independent beams are designed, then
    ``rank_eliminated`` *correlated* beams — pairwise sums of randomly
    drawn existing columns — are appended, so the output keeps ``mt``/
    ``mr`` columns but has rank ``mt - rank_eliminated``.  The draw is
    without replacement over ``min(2*rank_eliminated, M)`` columns
    (datasample 'Replace' false) and needs ``key`` when > 0.
    """
    rank_eliminated = max(0, min(int(rank_eliminated), mt - 3))
    # Deviation from the reference: additionally clamp so the pairwise
    # draw has RE+1 distinct columns available — the MATLAB at
    # Directional_Beam.m:170-174 indexes Fc_ind(RE+1) out of
    # min(2*RE, Mt-RE) drawn elements and *errors* when RE > (Mt-1)/2.
    rank_eliminated = min(rank_eliminated, (mt - 1) // 2, (mr - 1) // 2)
    if rank_eliminated > 0 and key is None:
        raise ValueError("rank_eliminated > 0 requires a PRNG key")
    mt_ind, mr_ind = mt - rank_eliminated, mr - rank_eliminated
    half = math.radians(searching_area_deg / 2.0)
    lo, hi = -math.sin(half), math.sin(half)

    def side(n_ant, nq_base, m):
        nq = oversample * nq_base
        grid = virtual_grid(nq)
        i_lo = int(np.argmin(np.abs(grid - lo)))
        i_hi = int(np.argmin(np.abs(grid - hi)))
        pos = np.arange(i_lo, i_hi + 1)
        npos = len(pos)
        sub = math.ceil(npos / m)
        n_overlap = sub * m - npos
        ol_l = math.ceil(n_overlap / 2)
        ol_r = n_overlap // 2
        overlap = set(range(1, ol_l + 1)) | set(range(m - ol_r, m))
        gain = np.full((npos, m), small_gain)
        start = 0
        for i in range(m):
            gain[start:start + sub, i] = 1.0
            start += sub - 1 if (i + 1) in overlap else sub
        beam_space = np.zeros((nq, m))
        beam_space[pos, :] = gain
        a = np.asarray(dictionary(n_ant, nq, cfg.k_d, jnp.complex128))
        # F = pinv(A') * beam_space  (ref :141)
        fmat = np.linalg.pinv(a.conj().T) @ beam_space
        fmat = fmat / np.linalg.norm(fmat)
        return quantize_ps(jnp.asarray(fmat), cfg.phase_bit)

    f = side(cfg.nt, cfg.grid_t, mt_ind)
    w = side(cfg.nr, cfg.grid_r, mr_ind)
    if rank_eliminated > 0:
        kf, kw = jax.random.split(key)

        def append_correlated(mat, m, k):
            # datasample(1:M, min(2*RE, M), 'Replace', false), then
            # column i+RE' = col(ind[i]) + col(ind[i+1])
            # (ref: Directional_Beam.m:170-177)
            ind = np.asarray(jax.random.permutation(k, m)[
                : min(2 * rank_eliminated, m)])
            cols = [mat[:, ind[i]] + mat[:, ind[i + 1]]
                    for i in range(rank_eliminated)]
            return jnp.concatenate([mat, jnp.stack(cols, axis=1)], axis=1)

        f = append_correlated(f, mt_ind, kf)
        w = append_correlated(w, mr_ind, kw)
    return f, w


def _beamspace_side(key, n_ant, nq, cfg, gain_fn, m):
    """Shared beam-space -> antenna-weight mapping: build an (nq, m) gain
    target with ``gain_fn``, least-squares map through the steering
    dictionary, normalize, 2-bit quantize (the common tail of the
    Directional_*/Region_* generators, ref: Directional_Beam.m:139-145)."""
    beam_space = gain_fn(key)
    a = np.asarray(dictionary(n_ant, nq, cfg.k_d, jnp.complex128))
    fmat = np.linalg.pinv(a.conj().T) @ np.asarray(beam_space)
    fmat = fmat / np.linalg.norm(fmat)
    return quantize_ps(jnp.asarray(fmat), cfg.phase_bit)


def directional_random_beams(key, mt: int, mr: int, cfg: ArrayConfig,
                             searching_area_deg: float,
                             oversample: int = 20,
                             small_gain: float = 0.05):
    """Directional beams with *random* per-position gains in each beam's
    FoV sub-grid (ref: Directional_Random_Beam.m:67-160): the FoV positions
    are partitioned into Mt overlapping sub-grids; beam i carries
    ``|N(0,1)|*20+5`` gains on its sub-grid and ``small_gain`` elsewhere.
    """
    half = math.radians(searching_area_deg / 2.0)
    lo, hi = -math.sin(half), math.sin(half)
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))

    def side(n_ant, nq_base, m):
        nq = oversample * nq_base
        grid = virtual_grid(nq)
        pos = np.arange(int(np.argmin(np.abs(grid - lo))),
                        int(np.argmin(np.abs(grid - hi))) + 1)
        npos = len(pos)
        sub = math.ceil(npos / m)
        n_overlap = sub * m - npos
        ol_l = math.ceil(n_overlap / 2)
        overlap = set(range(1, ol_l + 1)) | set(range(m - n_overlap // 2, m))

        def gains(_):
            gain = np.full((npos, m), small_gain)
            start = 0
            for i in range(m):
                gain[start:start + sub, i] = \
                    np.abs(rng.normal(size=sub)) * 20 + 5
                start += sub - 1 if (i + 1) in overlap else sub
            beam_space = np.zeros((nq, m))
            beam_space[pos, :] = gain
            return beam_space

        return _beamspace_side(None, n_ant, nq, cfg, gains, m)

    return side(cfg.nt, cfg.grid_t, mt), side(cfg.nr, cfg.grid_r, mr)


def region_random_beams(key, mt: int, mr: int, cfg: ArrayConfig,
                        searching_area_deg: float,
                        small_gain: float = 0.01):
    """Random-gain beams over the whole FoV with one normalized dominant
    peak per beam, peaks spread uniformly by circular shift
    (ref: Region_Random_Beam.m:66-135).
    """
    half = math.radians(searching_area_deg / 2.0)
    lo, hi = -math.sin(half), math.sin(half)
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))

    def side(n_ant, m):
        nq = n_ant                       # ref :77-78: NQ = N
        grid = virtual_grid(nq)
        pos = np.arange(int(np.argmin(np.abs(grid - lo))),
                        int(np.argmin(np.abs(grid - hi))) + 1)
        npos = len(pos)

        def gains(_):
            g = np.abs(rng.normal(size=(npos, m))) * 20 + 5
            mean_max = g.max(axis=0).mean()
            mean_rest = (g.sum() - mean_max * m) / m
            r = g.argmax(axis=0)
            for i in range(m):
                g[r[i], i] = mean_max
                rest = np.delete(g[:, i], r[i])
                rest = rest * mean_rest / rest.sum()
                g[np.arange(npos) != r[i], i] = rest
                g[:, i] = np.roll(g[:, i],
                                  (i) * round(npos / m) - r[i])
            beam_space = np.full((nq, m), small_gain)
            beam_space[pos, :] = g
            return beam_space

        return _beamspace_side(None, n_ant, nq, cfg, gains, m)

    return side(cfg.nt, mt), side(cfg.nr, mr)


def sweep_codebook_2d(cfg: ArrayConfig, n_az: int, n_el: int,
                      az_range: Tuple[float, float] = (-60.0, 60.0),
                      el_range: Tuple[float, float] = (-30.0, 30.0),
                      cols: Optional[int] = None) -> Codebook:
    """Azimuth x elevation sweep codebook over the URA geometry.

    JAX analogue of the sweeping-theta-and-phi probe codebooks
    (ref: codebook/generate_rx_codebook_16ant_sweeping_thetaNphi.py;
    36 = 6 az x 6 el combos on the testbed URA).  Beam (a, e) steers to
    azimuth[a], elevation[e] using the per-antenna URA positions.
    """
    from .grouping import location_phase, ura_coordinates

    coords = ura_coordinates(cfg.nr, cols)
    az = np.deg2rad(np.linspace(az_range[0], az_range[1], n_az))
    el = np.deg2rad(np.linspace(el_range[0], el_range[1], n_el))
    nps = 2 ** cfg.phase_bit
    bits = np.zeros((n_az * n_el, cfg.nr), np.int32)
    for i, a in enumerate(az):
        for j, e in enumerate(el):
            ph = -location_phase(coords, a, e)
            bits[i * n_el + j] = np.round(
                ph / (2 * np.pi / nps)).astype(np.int32) % nps
    return Codebook(bits=jnp.asarray(bits), amp=jnp.ones((cfg.nr,)),
                    phase_bit=cfg.phase_bit)


def sweep_codebook(cfg: ArrayConfig, n_az: int,
                   az_range: Tuple[float, float] = (-90.0, 90.0)) -> Codebook:
    """Azimuth sweep codebook: one quantized steering beam per azimuth.

    JAX analogue of the sweeping-phi probe codebooks
    (ref: codebook/generate_rx_codebook_16ant_sweeping_phi.py; 32 azimuths).
    """
    az = np.linspace(az_range[0], az_range[1], n_az, endpoint=False)
    a = steering_vector(jnp.sin(jnp.deg2rad(jnp.asarray(az))), cfg.nr,
                        cfg.k_d)                          # (n_az, nr)
    nps = 2 ** cfg.phase_bit
    bits = jnp.round(jnp.angle(a) / (2 * np.pi / nps)).astype(jnp.int32) % nps
    return Codebook(bits=bits, amp=jnp.ones((cfg.nr,)),
                    phase_bit=cfg.phase_bit)


# -------------------------------------------------------------- multires family

#: per-antenna calibration bits of the reference's 16-of-32 testbed panel
#: (ref: generate_rx_codebook_multires_16ant.py:49-50, active-antenna order)
REFERENCE_CALIBRATION_16 = np.array(
    [0, 2, 3, 0, 0, 3, 0, 3, 1, 0, 0, 3, 0, 3, 0, 0], np.int32)


def default_groupings(n_ant: int) -> Tuple[Sequence[Sequence[int]], ...]:
    """Tier groupings: groups of 4, groups of 2, singletons.

    Generalizes the hand-derived hardware grouping of the reference
    (ref: generate_rx_codebook_multires_16ant.py:48 and
    codebook/group_antenna/group_ant_kernel.m:9-69, which groups antennas by
    calibrated-phase proximity) to contiguous groups for an arbitrary array.
    """
    g4 = [list(range(i, min(i + 4, n_ant))) for i in range(0, n_ant, 4)]
    g2 = [list(range(i, min(i + 2, n_ant))) for i in range(0, n_ant, 2)]
    g1 = [[i] for i in range(n_ant)]
    return (g4, g2, g1)


def multires_codebook(key, n_ant: int, rounds: Tuple[int, int, int] = (32, 64, 64),
                      phase_bit: int = 2,
                      calibration: Optional[np.ndarray] = None,
                      groupings=None) -> Tuple[Codebook, Codebook]:
    """Three-tier multi-resolution codebook.

    Tier t draws one random phase bit per antenna *group* (group sizes
    4 / 2 / 1), so coarse tiers have fewer independent phase degrees of
    freedom — the 2ACE multi-resolution probing structure
    (ref: generate_rx_codebook_multires_16ant.py:47-144).

    Returns ``(inferred, actual)``: the ideal table and the
    calibration-compensated table actually flashed to hardware
    (``actual_bit = (ideal - calibration) mod 2^b``, ref :84-87).
    """
    if groupings is None:
        groupings = default_groupings(n_ant)
    if calibration is None:
        calibration = np.zeros(n_ant, np.int32)
    calibration = jnp.asarray(calibration)
    nps = 2 ** phase_bit

    tiers_inf = []
    for tier, (n_rounds, groups) in enumerate(zip(rounds, groupings)):
        k_t = jax.random.fold_in(key, tier)
        gbits = jax.random.randint(k_t, (n_rounds, len(groups)), 0, nps)
        # scatter group bit to each antenna of the group
        ant_of_group = np.zeros(n_ant, np.int32)
        for gi, g in enumerate(groups):
            for a in g:
                ant_of_group[a] = gi
        bits = gbits[:, jnp.asarray(ant_of_group)]
        tiers_inf.append(bits)

    inferred = jnp.concatenate(tiers_inf, axis=0)
    actual = (inferred - calibration[None, :]) % nps
    amp = jnp.ones((n_ant,))
    return (Codebook(bits=inferred, amp=amp, phase_bit=phase_bit),
            Codebook(bits=actual, amp=amp, phase_bit=phase_bit,
                     calibration=np.asarray(calibration)))


# -------------------------------------------------------------------- ACO family

def aco_sweep_codebook(n_ant: int, ref_bit: int = 0,
                       phase_bit: int = 2) -> Codebook:
    """Per-antenna phase-sweep masks for Agile-Link-style ACO calibration.

    Entry (i*2^b + p) keeps all antennas at ``ref_bit`` except antenna i at
    phase bit p.  ref: codebook/generate_rx_codebook_16ant_ACO.py:44-165.
    """
    nps = 2 ** phase_bit
    bits = np.full((n_ant * nps, n_ant), ref_bit, np.int32)
    for i in range(n_ant):
        for p in range(nps):
            bits[i * nps + p, i] = p
    return Codebook(bits=jnp.asarray(bits), amp=jnp.ones((n_ant,)),
                    phase_bit=phase_bit)


def rss_to_csi(rss_linear, n_ant: int, phase_bit: int = 2):
    """Recover per-antenna complex CSI from a phase-sweep RSS trace.

    4-point DFT over the 2^b phase positions: the first harmonic's angle is
    the antenna's relative phase; the amplitude follows from the DC and
    first-harmonic magnitudes.  ref: main/codebook_library.py:518-526.
    """
    nps = 2 ** phase_bit
    rss = jnp.reshape(rss_linear, (n_ant, nps))
    spec = jnp.fft.fft(rss, axis=-1)
    gamma = jnp.real(spec[:, 0])
    first = spec[:, 1]
    delta = jnp.abs(first)
    csi_phase = jnp.angle(first)
    amp = 0.5 * (jnp.sqrt(jnp.maximum(gamma + 2 * delta, 0.0))
                 - jnp.sqrt(jnp.maximum(gamma - 2 * delta, 0.0)))
    return jnp.abs(amp) * jnp.exp(1j * csi_phase)


def conj_phase_bits(h, phase_bit: int = 2):
    """Round conj-phase of a CSI vector to phase bits (the ACO beam).

    ref: main/codebook_library.py:584-591 (get_ACO_codebook_bit).
    """
    nps = 2 ** phase_bit
    w = jnp.round(jnp.angle(jnp.conj(h)) / (2 * np.pi / nps)).astype(jnp.int32)
    return w % nps


# -------------------------------------------------------------- kron assembly

def kron_probe_rows(tx_rows, rx_rows, interleave: bool = False):
    """Assemble full probe rows from per-round Tx sectors and one Rx row.

    ``tx_rows``: (rounds, sectors, nt) complex; ``rx_rows``: (rounds, nr).
    Row (i, j) is ``kron(tx_rows[i, j], rx_rows[i])`` — Rx index fastest,
    matching vec(H).

    Row ORDERING (pinned against the shipped codebook_mat artifacts in
    tests/test_reference_artifacts.py):

    - ``interleave=False`` (default): round-major, sector index fastest —
      flat row = sector + sectors*round.  This is MATLAB's MULTIRES
      ordering ``permute(cb, [2,1,3])`` + column-major reshape
      (ref: processsing_codebook_multires.m:60-61): resolution tiers
      occupy CONTIGUOUS row ranges (tier 1 = rows [0, 62*32) for the
      16-antenna codebook), which the tier-aware probe sampling assumes
      (ref: ..._multiresolution.m:111-112,137-143 and
      pipeline/recovery._pick_m_indices).

    - ``interleave=True``: sector-major, round index fastest —
      flat row = round + rounds*sector.  This is the RANDOM codebook
      ordering (non-permuted column-major reshape,
      ref: processsing_codebook_random.m:54-62).
    """
    rounds, sectors, nt_ = tx_rows.shape
    nr_ = rx_rows.shape[-1]
    cb = jnp.einsum("ijt,ir->ijtr", tx_rows, rx_rows)
    cb = cb.reshape(rounds, sectors, nt_ * nr_)
    if interleave:
        cb = jnp.swapaxes(cb, 0, 1)
    return cb.reshape(rounds * sectors, nt_ * nr_)


def svd_beamformer_bits(h, phase_bit: int = 2, compensation=None):
    """Best 2-bit Tx/Rx beam pair from an (estimated) channel matrix.

    Quantize the conjugated phases of all right/left singular vectors, then
    exhaustively pick the (tx, rx) singular-vector pair maximizing predicted
    RSS ``|w_t^T H w_r|^2``.  Returns integer bit vectors ``(wt, wr)``.
    ref: main/codebook_library.py:57-95 (svd_beamformer).

    ``compensation``: per-antenna hardware phase offsets (radians) subtracted
    from the winning beam before the final bit rounding
    (ref: svd_beamformer_compensation, codebook_library.py:97-135).
    """
    nps = 2 ** phase_bit
    step = 2.0 * np.pi / nps
    # ref uses rows of V^H from svd(H) (Rx side) and svd(H^T) (Tx side)
    _, _, vh_r = jnp.linalg.svd(h)
    _, _, vh_t = jnp.linalg.svd(h.T)
    wr_ang = -jnp.round(jnp.angle(vh_r) / step) * step   # (k, nr)
    wt_ang = -jnp.round(jnp.angle(vh_t) / step) * step   # (k, nt)
    wr = jnp.exp(1j * wr_ang).T                          # (nr, k)
    wt = jnp.exp(1j * wt_ang).T                          # (nt, k)
    # predicted RSS for every (tx, rx) pair: |wt_i^T H wr_j|^2
    gain = jnp.abs(jnp.einsum("ti,tr,rj->ij", wt, h, wr)) ** 2
    idx = jnp.argmax(gain)
    i, j = idx // gain.shape[1], idx % gain.shape[1]
    wt_win, wr_win = wt[:, i], wr[:, j]
    if compensation is not None:
        comp = jnp.exp(-1j * jnp.asarray(compensation))
        wt_win = wt_win * comp[:wt_win.shape[0]]
        wr_win = wr_win * comp[:wr_win.shape[0]]
    wt_bits = jnp.round(jnp.angle(wt_win) / step).astype(jnp.int32) % nps
    wr_bits = jnp.round(jnp.angle(wr_win) / step).astype(jnp.int32) % nps
    return wt_bits, wr_bits


def evaluation_codebook(key, h_estimates, h_directional=None,
                        wt_aco_bits=None, wr_aco_bits=None,
                        nt: int = 16, nr: int = 16, phase_bit: int = 2,
                        compensation=None, n_probe: int = 50):
    """Assemble the on-air evaluation codebook from recovered channels.

    ref: main/codebook_library.py:192-451 (codebook_generator) — one SVD
    beam pair per estimated H (the first with hardware-offset compensation,
    ref :197-200), one per directional-H estimate (ref :205-209), the ACO
    codeword pair (ref :211-212), and a block of fixed probe sectors
    (ref :215-300: hard-coded hardware-calibrated tables; here random 2-bit
    sectors, since the originals encode chip-specific calibration).

    Returns ``(tx_bits, rx_bits)`` int32 arrays of shape (K, nt) / (K, nr).
    """
    tx, rx = [], []
    h_estimates = jnp.asarray(h_estimates)
    if h_estimates.ndim == 1:
        h_estimates = h_estimates[None]
    for i in range(h_estimates.shape[0]):
        h = h_estimates[i].reshape(nt, nr)
        comp = compensation if i == 0 else None
        wt_b, wr_b = svd_beamformer_bits(h, phase_bit, compensation=comp)
        tx.append(wt_b)
        rx.append(wr_b)
    if h_directional is not None:
        h_directional = jnp.asarray(h_directional)
        if h_directional.ndim == 1:
            h_directional = h_directional[None]
        for i in range(h_directional.shape[0]):
            h = h_directional[i].reshape(nt, nr)
            wt_b, wr_b = svd_beamformer_bits(h, phase_bit)
            tx.append(wt_b)
            rx.append(wr_b)
    if wt_aco_bits is not None:
        tx.append(jnp.asarray(wt_aco_bits, jnp.int32))
        rx.append(jnp.asarray(wr_aco_bits, jnp.int32))
    if n_probe > 0:
        k1, k2 = jax.random.split(key)
        nps = 2 ** phase_bit
        tx.append(jax.random.randint(k1, (n_probe, nt), 0, nps))
        rx.append(jax.random.randint(k2, (n_probe, nr), 0, nps))
    tx_bits = jnp.concatenate([jnp.atleast_2d(t) for t in tx], axis=0)
    rx_bits = jnp.concatenate([jnp.atleast_2d(r) for r in rx], axis=0)
    return tx_bits.astype(jnp.int32), rx_bits.astype(jnp.int32)
