"""Testbed campaign orchestration — the ``main.py`` driver as a library.

JAX rewrite of the reference's end-to-end testbed run
(ref: main/main.py:26-483): five probing campaigns (thetaNphi sweep, phi
sweep, directional, random, multires) against a measurement provider,
followed by repeated estimation over the probe-budget grid and a
beamforming comparison of the recovered channels.

Hardware specifics (SSH, firmware reloads, .brd flashing) live behind the
:class:`~twoace.sensing.provider.MeasurementProvider` protocol; campaign
mechanics preserved here: per-round incremental checkpointing, retry
ladder, thermal guard, multires tier shuffling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ArrayConfig, MethodFlags
from ..sensing.codebooks import (
    aco_sweep_codebook,
    conj_phase_bits,
    directional_beams_angular,
    evaluation_codebook,
    kron_probe_rows,
    multires_codebook,
    random_codebook,
    rss_to_csi,
    svd_beamformer_bits,
    sweep_codebook,
    sweep_codebook_2d,
)
from ..sensing.provider import MeasurementProvider, ThermalGuard
from ..utils.checkpoint import CampaignStore
from .recovery import (
    CampaignConfig,
    recover_a2nuclear,
    recover_a2only,
    recover_directional,
    recover_multiresolution,
    recover_phaselift,
)


@dataclasses.dataclass
class TestbedConfig:
    """Probe counts of the reference campaigns (ref: main.py:28-81)."""

    array: ArrayConfig = ArrayConfig()
    n_theta_phi: int = 36       #: elevation+azimuth sweep rounds
    n_phi: int = 32             #: azimuth sweep rounds
    n_directional: int = 32     #: directional rounds (x sectors)
    n_random_rounds: int = 64   #: random codebook rounds
    sectors_per_round: int = 62
    multires_rounds: Sequence[int] = (32, 64, 64)
    n_repeats: int = 2          #: estimation repeats (ref: 40)
    checkpoint_dir: Optional[str] = None


class TestbedRunner:
    def __init__(self, cfg: TestbedConfig, provider: MeasurementProvider,
                 key=None, guard: Optional[ThermalGuard] = None):
        self.cfg = cfg
        self.provider = provider
        self.key = jax.random.PRNGKey(0) if key is None else key
        self.guard = guard
        self.store = CampaignStore(cfg.checkpoint_dir) \
            if cfg.checkpoint_dir else None
        self.results: Dict[str, Dict[str, np.ndarray]] = {}

    # ------------------------------------------------------------- campaigns

    def _measure_rounds(self, name: str, tx_rows, rx_rows,
                        interleave: bool = False) -> Dict[str, np.ndarray]:
        """Measure all (round, sector) probes with per-round checkpointing
        and thermal guarding (ref: main.py:97-134 structure)."""
        rounds = rx_rows.shape[0]
        sectors = tx_rows.shape[1]
        done = set(self.store.completed_rounds(name)) if self.store else set()
        rss = np.zeros((rounds, sectors))
        for i in range(rounds):
            if i in done:                       # resume from checkpoint
                rss[i] = self.store.load(name, i)["rss"]
                continue
            rows = kron_probe_rows(tx_rows[i:i + 1], rx_rows[i:i + 1])
            rss[i] = self.provider.measure(rows)
            if self.guard is not None:
                self.guard.wait_until_cool()    # ref: main.py:120-132
            if self.store:
                self.store.save(name, {"rss": rss[i]}, i)
        rows_all = kron_probe_rows(tx_rows, rx_rows, interleave=interleave)
        if interleave:
            rss_flat = rss.T.reshape(-1)        # sector-major, matching rows
        else:
            rss_flat = rss.reshape(-1)
        out = {"rss_dbm": rss_flat, "rows": np.asarray(rows_all)}
        self.results[name] = out
        return out

    def run_sweep_campaigns(self):
        """Campaigns 1-2: elevation/azimuth sweeps (ref: main.py:97-177).

        Probes use one sweep beam per round on both sides (single sector)."""
        cfg = self.cfg.array
        n_el = max(1, int(round(self.cfg.n_theta_phi ** 0.5)))
        theta_cb = sweep_codebook_2d(cfg, self.cfg.n_theta_phi // n_el, n_el)
        for name, cb in (("theta_phi", theta_cb),
                         ("phi", sweep_codebook(cfg, self.cfg.n_phi))):
            rows_side = cb.rows()
            tx = rows_side[:, None, :]           # (rounds, 1, nt)
            rx = jnp.conj(rows_side)             # combiner side
            self._measure_rounds(name, tx, rx)
        return self

    def run_random_campaign(self):
        """Campaign 4: random probing, 64 rounds x 62 Tx sectors
        (ref: main.py:241-302, generate_rx_codebook_16ant_random.py)."""
        cfg = self.cfg.array
        k1, k2 = jax.random.split(jax.random.fold_in(self.key, 4))
        rounds, sectors = self.cfg.n_random_rounds, self.cfg.sectors_per_round
        tx_cb = random_codebook(k1, rounds * sectors, cfg.nt)
        rx_cb = random_codebook(k2, rounds, cfg.nr)
        tx = tx_cb.rows().reshape(rounds, sectors, cfg.nt)
        rx = rx_cb.rows()
        # round-fastest ordering, matching the shipped random_probe_cb
        # row layout (processsing_codebook_random.m:54-62 reshape without
        # permute; pinned in tests/test_reference_artifacts.py)
        self._measure_rounds("random", tx, rx, interleave=True)
        return self

    def run_directional_campaign(self):
        """Campaign 3: directional sectors, n_directional Rx beams x
        n_directional Tx sectors (ref: main.py:183-220)."""
        cfg = self.cfg.array
        nd = self.cfg.n_directional
        f, w = directional_beams_angular(nd, nd, cfg, (-90.0, 90.0),
                                         (-90.0, 90.0))
        tx = jnp.broadcast_to(f.T[None], (nd, nd, cfg.nt))   # all Tx sectors
        rx = w.T                                             # one Rx beam/round
        self._measure_rounds("directional", tx, rx)
        return self

    def collect_aco(self, tx_bits=None, rx_bits=None):
        """ACO calibration: per-antenna phase sweeps on each side, 4-point
        DFT phase recovery, conjugate 2-bit codeword.

        ref: main.py:398-419 -> codebook_library.py collect_ACO_tx (:528-582),
        collect_ACO_rx (:164-190), rss2csi (:518-526),
        get_ACO_codebook_bit (:584-591).  ``tx_bits``/``rx_bits``: fixed
        far-side beams held during the sweep (default all-zeros sector).
        Returns ``(wt_aco_bits, wr_aco_bits)``.
        """
        cfg = self.cfg.array
        nps = 2 ** cfg.phase_bit
        if tx_bits is None:
            tx_bits = jnp.zeros((cfg.nt,), jnp.int32)
        if rx_bits is None:
            rx_bits = jnp.zeros((cfg.nr,), jnp.int32)
        tx_fixed = jnp.exp(1j * tx_bits * (2 * np.pi / nps)) / np.sqrt(cfg.nt)
        rx_fixed = jnp.exp(1j * rx_bits * (2 * np.pi / nps)) / np.sqrt(cfg.nr)

        out_bits = []
        for side, n_ant, far in (("rx", cfg.nr, tx_fixed),
                                 ("tx", cfg.nt, rx_fixed)):
            sweep = aco_sweep_codebook(n_ant, phase_bit=cfg.phase_bit)
            masks = sweep.rows()                        # (n_ant*nps, n_ant)
            n_masks = masks.shape[0]
            if side == "rx":
                tx_r = jnp.broadcast_to(far[None, None, :],
                                        (n_masks, 1, cfg.nt))
                rows = kron_probe_rows(tx_r, masks)
            else:
                rx_r = jnp.broadcast_to(far[None, :], (n_masks, cfg.nr))
                rows = kron_probe_rows(masks[:, None, :], rx_r)
            rss_dbm = np.concatenate(
                [self.provider.measure(rows[i:i + 1])
                 for i in range(rows.shape[0])])
            rss_lin = 10.0 ** (jnp.asarray(rss_dbm) / 10.0)
            csi = rss_to_csi(rss_lin, n_ant, cfg.phase_bit)
            out_bits.append(conj_phase_bits(csi, cfg.phase_bit))
        wr_aco, wt_aco = out_bits
        if self.store:
            self.store.save("aco", {"wt_bits": np.asarray(wt_aco),
                                    "wr_bits": np.asarray(wr_aco)})
        return wt_aco, wr_aco

    def run_multires_campaign(self):
        """Campaign 5: three-tier multires probing (ref: main.py:317-394).

        Rows use the MATLAB multires ordering (sector fastest, tiers in
        contiguous row ranges — ``permute(cb,[2,1,3])`` then reshape,
        processsing_codebook_multires.m:60-61), which the tier-aware
        sampling of :func:`..pipeline.recovery._pick_m_indices` assumes
        (row offsets 1984/3968/3968, ..._multiresolution.m:111-112)."""
        cfg = self.cfg.array
        k1, k2 = jax.random.split(jax.random.fold_in(self.key, 5))
        rounds = tuple(self.cfg.multires_rounds)
        total_rounds = sum(rounds)
        sectors = self.cfg.sectors_per_round
        rx_cb, _ = multires_codebook(k1, cfg.nr, rounds)
        tx_cb, _ = multires_codebook(
            k2, cfg.nt, tuple(r * sectors for r in rounds))
        tx = tx_cb.rows().reshape(total_rounds, sectors, cfg.nt)
        rx = rx_cb.rows()
        self._measure_rounds("multires", tx, rx, interleave=False)
        return self

    # ------------------------------------------------------------ estimation

    def estimate(self, campaign: str = "random", method: str = "a2only",
                 seed_id: int = 1, cc: Optional[CampaignConfig] = None):
        """Recover the channel from a measured campaign over the M grid
        (ref: main.py:426-440)."""
        data = self.results[campaign]
        recover = {"a2only": recover_a2only,
                   "a2nuclear": recover_a2nuclear,
                   "multiresolution": recover_multiresolution,
                   "phaselift": recover_phaselift,
                   "directional": recover_directional}[method]
        kwargs = {"cc": cc} if cc is not None else {}
        out = recover(jnp.asarray(data["rows"]), jnp.asarray(data["rss_dbm"]),
                      seed_id=seed_id, **kwargs)
        if self.store:
            self.store.save(f"estimate_{campaign}_{method}_{seed_id}", {
                "h_amp": out.h_amp, "h_angle": out.h_angle,
                "m_grid": np.asarray(out.m_grid)})
        return out

    def beamforming_comparison(self, h_estimates: Dict[str, np.ndarray]):
        """Flash each method's SVD beamformer and measure its RSS
        (ref: main.py:452-483).  ``h_estimates``: method -> (n,) vec(H)."""
        cfg = self.cfg.array
        rss_bf: Dict[str, float] = {}
        for name, vec_h in h_estimates.items():
            # (nt, nr) orientation: vec(H) is Rx-fastest, and the beamformer
            # expects rows = Tx antennas (ref: codebook_generator reshape
            # [num_tx_ant, num_rx_ant], codebook_library.py:197)
            h = jnp.asarray(vec_h).reshape(cfg.nt, cfg.nr)
            wt_bits, wr_bits = svd_beamformer_bits(h, cfg.phase_bit)
            wt = jnp.exp(1j * wt_bits * (np.pi / 2))
            wr = jnp.exp(1j * wr_bits * (np.pi / 2))
            # beams enter the measurement UNconjugated, matching the codebook
            # model rss = |kron(tx, rx) . vecH| (processsing_codebook_random.m
            # :54-62) that the recovery was trained under
            row = kron_probe_rows(wt[None, None, :], wr[None, :])
            rss_bf[name] = float(self.provider.measure(row)[0])
        if self.store:
            self.store.save("beamforming", {
                k: np.asarray(v) for k, v in rss_bf.items()})
        return rss_bf

    def evaluate_codebook_rss(self, h_estimates, h_directional=None,
                              aco_bits=None, compensation=None,
                              n_probe: int = 50):
        """Assemble the full on-air evaluation codebook (SVD beams per
        estimate, directional beams, ACO beam, probe sectors) and measure
        every beam's RSS (ref: main.py:452-481 + codebook_generator)."""
        cfg = self.cfg.array
        nps = 2 ** cfg.phase_bit
        wt_aco, wr_aco = (aco_bits if aco_bits is not None else (None, None))
        tx_bits, rx_bits = evaluation_codebook(
            jax.random.fold_in(self.key, 6), jnp.asarray(h_estimates),
            h_directional=h_directional, wt_aco_bits=wt_aco,
            wr_aco_bits=wr_aco, nt=cfg.nt, nr=cfg.nr,
            phase_bit=cfg.phase_bit, compensation=compensation,
            n_probe=n_probe)
        tx = jnp.exp(1j * tx_bits * (2 * np.pi / nps)) / np.sqrt(cfg.nt)
        rx = jnp.exp(1j * rx_bits * (2 * np.pi / nps)) / np.sqrt(cfg.nr)
        # unconjugated kron: the convention the SVD/ACO beams maximize under
        rows = kron_probe_rows(tx[:, None, :], rx)
        rss = np.asarray(self.provider.measure(rows))
        if self.store:
            self.store.save("evaluation_codebook", {
                "rss_dbm": rss, "tx_bits": np.asarray(tx_bits),
                "rx_bits": np.asarray(rx_bits)})
        return rss, np.asarray(tx_bits), np.asarray(rx_bits)
