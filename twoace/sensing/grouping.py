"""Antenna grouping and hardware phase calibration for multi-resolution
codebook design.

JAX rewrite of the reference's URA grouping/calibration tooling:
  - greedy antenna grouping by calibrated-phase proximity
    (ref: codebook/group_antenna/group_ant_kernel.m:9-69, URA coordinate
    maps :71-82, driver group_ant_main.m:12-29)
  - per-antenna phase offsets from a measured steering calibration
    (ref: codebook/directional_codebook_generator/AntennaPhaseShifts.m:3-8)
  - ideal URA steering vectors incl. multi-panel geometry with 0.58-lambda
    element spacing (ref: IdealSteeringVector{PerPanel,AllPanel}.m)

The grouping itself is an offline, host-side design step (numpy): groups are
static metadata consumed by :func:`..sensing.codebooks.multires_codebook`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

#: half-wavelength-normalized element pitch of the QCA6310 URA (0.58 lambda,
#: ref: group_ant_kernel.m:19-20 "2 * 0.58 * pi")
ELEMENT_PITCH = 0.58


def ura_coordinates(n_ant: int, cols: Optional[int] = None) -> np.ndarray:
    """(n_ant, 2) integer (x, y) element coordinates of a rectangular URA.

    The reference uses a hand-measured coordinate table for its 32-element
    panel (ref: group_ant_kernel.m:76-77); for the general framework we use
    a row-major rectangular grid.
    """
    if cols is None:
        cols = int(np.ceil(np.sqrt(n_ant)))
    idx = np.arange(n_ant)
    return np.stack([idx % cols, idx // cols], axis=1)


def location_phase(coords: np.ndarray, azimuth_rad: float,
                   elevation_rad: float) -> np.ndarray:
    """Geometric phase of each element toward (az, el).

    ref: group_ant_kernel.m:19-20,71-82 — az component
    ``cos(az) cos(el) * 2*pi*pitch * x`` and el component
    ``cos(el) sin(az) * 2*pi*pitch * y``.
    """
    az_k = np.cos(azimuth_rad) * np.cos(elevation_rad) * 2 * np.pi \
        * ELEMENT_PITCH
    el_k = np.cos(elevation_rad) * np.sin(azimuth_rad) * 2 * np.pi \
        * ELEMENT_PITCH
    return az_k * coords[:, 0] + el_k * coords[:, 1]


def group_antennas(phase_offsets: np.ndarray, group_size: int,
                   phase_bit: int = 2,
                   azimuth_rad: float = 0.0, elevation_rad: float = 0.0,
                   coords: Optional[np.ndarray] = None
                   ) -> Tuple[List[List[int]], np.ndarray]:
    """Greedy grouping of antennas with nearest 2-bit-compatible phases.

    Uses the first unallocated antenna as the group reference and picks the
    ``group_size - 1`` antennas whose total (hardware + geometric) phase
    offset is closest to a representable 2^b phase step; emits per-antenna
    calibration bits.  ref: group_ant_kernel.m:28-68.

    Returns ``(groups, calibration_bits)``.
    """
    n = len(phase_offsets)
    if coords is None:
        coords = ura_coordinates(n)
    geo = location_phase(coords, azimuth_rad, elevation_rad)
    nps = 2 ** phase_bit
    grid = np.arange(nps + 1) * (2 * np.pi / nps)   # 0..2pi inclusive

    allocated = np.zeros(n, bool)
    groups: List[List[int]] = []
    calib_bits = np.zeros(n, np.int64)

    for _ in range(n // group_size):
        avail = np.where(~allocated)[0]
        first = avail[0]
        rest = avail[1:]
        total = np.mod(phase_offsets[rest] - phase_offsets[first]
                       + (geo[rest] - geo[first]), 2 * np.pi)
        dist = np.abs(total[:, None] - grid[None, :])
        cost = dist.min(axis=1)
        best_bit = dist.argmin(axis=1) % nps
        order = np.argsort(cost, kind="stable")[:group_size - 1]
        members = [int(first)] + [int(rest[k]) for k in order]
        for k in order:
            calib_bits[rest[k]] = best_bit[k]
        allocated[members] = True
        groups.append(members)
    return groups, calib_bits


def per_panel_phase_offsets(steering_phase: np.ndarray,
                            azim_deg: np.ndarray, elev_deg: np.ndarray,
                            beam_map: np.ndarray, cols: int = 6,
                            pitch: float = ELEMENT_PITCH) -> np.ndarray:
    """Per-antenna hardware phase offsets (radians) from a measured
    per-panel steering calibration sweep.

    Reproduces the testbed's calibration chain exactly
    (ref: AntennaPhaseShifts.m:3-8 + IdealSteeringVectorPerPanel.m:9-41):
    the ideal per-panel steering vector over the (az, el) sweep grid is the
    CONJUGATED geometric phasor (MATLAB's trailing ``'`` is ctranspose),
    indexed by the 1-based ``beam_map`` and referenced to the panel's first
    mapped antenna; the offset is the angle of the sweep-averaged
    measured * conj(ideal) phasor.

    Validated to machine precision against the SHIPPED testbed artifacts
    (steering_vector_calib.mat -> hardware_phaseoffset.mat) in
    tests/test_reference_artifacts.py.

    ``steering_phase``: (n_beam, n_az, n_el) measured phases;
    ``beam_map``: 1-based panel-antenna indices (n_beam,).
    """
    n_ant = steering_phase.shape[0]
    total = int(beam_map.max())
    total = max(total, cols * cols)
    idx = np.arange(total)
    geom = np.stack([idx % cols, idx // cols], axis=1).astype(float) * pitch
    az = np.deg2rad(np.asarray(azim_deg, float))
    el = np.deg2rad(np.asarray(elev_deg, float))
    ux = np.cos(az)[:, None] * np.cos(el)[None, :]
    uy = np.sin(az)[:, None] * np.cos(el)[None, :]
    phase = 2 * np.pi * (geom[:, 0, None, None] * ux[None]
                         + geom[:, 1, None, None] * uy[None])
    ideal = np.conj(np.exp(1j * phase))[np.asarray(beam_map, int) - 1]
    ideal = ideal * np.conj(ideal[0:1])
    diff = np.exp(1j * steering_phase) * np.conj(ideal)
    return np.angle(diff.reshape(n_ant, -1).sum(axis=1))


def antenna_phase_shifts(steering_phase: np.ndarray,
                         ideal_steering: np.ndarray) -> np.ndarray:
    """Per-antenna hardware phase offsets from a measured steering calibration.

    ``exp(1j*angle(sum over angles of measured * conj(ideal)))`` — the
    angle-averaged phasor mismatch.  ref: AntennaPhaseShifts.m:3-8.
    Inputs: (n_ant, n_az, n_el) arrays (phase / complex ideal).
    """
    measured = np.exp(1j * steering_phase)
    diff = measured * np.conj(ideal_steering)
    return np.angle(diff.reshape(diff.shape[0], -1).sum(axis=1))


def ideal_steering_ura(azim_deg: Sequence[float], elev_deg: Sequence[float],
                       coords: np.ndarray,
                       panel_offsets: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Ideal URA steering phasors over an (az, el) grid: (n_ant, n_az, n_el).

    Multi-panel arrays add the 0.58*lambda*6 panel-spacing phase
    (ref: IdealSteeringVectorAllPanel.m:25-35).
    """
    az = np.deg2rad(np.asarray(azim_deg))
    el = np.deg2rad(np.asarray(elev_deg))
    # unit direction vector per (az, el)
    ux = np.cos(az)[:, None] * np.cos(el)[None, :]
    uy = np.sin(az)[:, None] * np.cos(el)[None, :]
    pos = coords.astype(float) * ELEMENT_PITCH
    phase = 2 * np.pi * (pos[:, 0, None, None] * ux[None]
                         + pos[:, 1, None, None] * uy[None])
    if panel_offsets is not None:
        po = panel_offsets.astype(float)
        phase = phase + 2 * np.pi * (po[:, 0, None, None] * ux[None]
                                     + po[:, 1, None, None] * uy[None])
    return np.exp(1j * phase)
