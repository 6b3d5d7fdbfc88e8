"""CLI entry-point tests (the framework-native replacement for the
reference's 11 MATLAB entry scripts + main.py driver, SURVEY §2.5)."""

import json

import numpy as np

from twoace.cli import build_parser, main


def _run(capsys, argv):
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


TINY = ["--nt", "4", "--nr", "4", "--trials", "1", "--maxiter", "20",
        "--restarts", "1", "--platform", "cpu"]


def test_parser_covers_reference_entry_points():
    ap = build_parser()
    subs = ap._subparsers._group_actions[0].choices
    # one subcommand per reference entry-point family (O1-O3)
    for cmd in ["vs-m", "vs-snr", "vs-sr", "mobility", "testbed", "recover"]:
        assert cmd in subs


def test_cli_vs_m_tiny(capsys, tmp_path):
    out = tmp_path / "vsm.npz"
    res = _run(capsys, ["vs-m", *TINY, "--m-grid", "40", "--paths", "1",
                        "--noiseless", "--out", str(out)])
    assert res["cmd"] == "vs-m"
    assert res["m_grid"] == [40]
    data = np.load(out)
    assert "m_grid" in data and any(k.startswith("nmse_") for k in data)
    # A2 on 4x4 with 40 noiseless probes recovers well even at 20 iters
    nmse_db = next(iter(res["nmse_db"].values()))[0]
    assert nmse_db < -3.0, nmse_db


def test_cli_testbed_multires_dispatch(capsys):
    """'multires' CLI choice must reach TestbedRunner.estimate's
    'multiresolution' key (regression: ADVICE r1 KeyError)."""
    res = _run(capsys, ["testbed", *TINY, "--method", "multires",
                        "--rounds", "2", "--sectors", "4"])
    assert res["cmd"] == "testbed"
    assert res["method"] == "multires"


def test_cli_recover_multires_tiers(capsys, tmp_path):
    """recover --method multires must actually enable tier-aware sampling
    (regression: ADVICE r1 silent multires=False)."""
    import jax
    import twoace as t2
    from twoace.models import generate_channel
    from twoace.sensing.codebooks import random_codebook, kron_probe_rows

    cfg = t2.ArrayConfig(nt=4, nr=4)
    key = jax.random.PRNGKey(3)
    ch = generate_channel(key, cfg, t2.ChannelConfig(n_paths=1, rician_k=0),
                          batch=1)
    tx = random_codebook(jax.random.fold_in(key, 1), 8, cfg.nt).rows()
    rx = random_codebook(jax.random.fold_in(key, 2), 8, cfg.nr).rows()
    rows = np.asarray(kron_probe_rows(
        tx.reshape(1, 8, cfg.nt).repeat(8, 0), rx)).reshape(-1, cfg.n)
    amp = np.abs(rows @ np.asarray(ch.vec_h[0])) + 1e-9
    rss_dbm = 10 * np.log10(np.maximum(amp ** 2 * 1000, 1e-30))
    probes = tmp_path / "probes.npz"
    np.savez(probes, cb_rows=rows, rss_dbm=rss_dbm)
    res = _run(capsys, ["recover", *TINY, "--probes", str(probes),
                        "--method", "multires"])
    assert res["cmd"] == "recover"


def test_import_main_module_is_safe():
    """Importing twoace.__main__ must not parse sys.argv
    (regression: ADVICE r1 SystemExit on import)."""
    import importlib
    import twoace.__main__ as m

    importlib.reload(m)  # would raise SystemExit(2) without the guard


def test_json_summary_is_strict(capsys):
    """NaN must map to null in the summary line (ADVICE r1: bare NaN breaks
    jq/JSON.parse)."""
    from types import SimpleNamespace

    from twoace.cli import _emit

    _emit({"a": float("nan"), "b": np.float64("nan"),
           "c": np.array([np.nan, 1.0]), "d": [float("nan")]},
          {}, SimpleNamespace(out=None))
    line = capsys.readouterr().out.strip()
    parsed = json.loads(line)          # strict parse — bare NaN would fail
    assert "NaN" not in line
    assert parsed == {"a": None, "b": None, "c": [None, 1.0], "d": [None]}


def test_cli_mobility_tiny(capsys, tmp_path):
    out = tmp_path / "mob.mat"
    res = _run(capsys, ["mobility", *TINY, "--windows", "3",
                        "--window-probes", "30", "--out", str(out), "--mat"])
    assert res["cmd"] == "mobility"
    assert len(res["probe_budget"]) == 3
    import scipy.io as sio

    saved = sio.loadmat(out)
    assert "rss_error" in saved


def test_probe_budget_grid_pins_reference_m_grid():
    """M grid = round(linspace(2, sqrt(4*Nt*Nr), 8)).^2 with MATLAB
    half-away-from-zero rounding (ref: A2only.m:110-111)."""
    from twoace.config import probe_budget_grid

    assert probe_budget_grid(16, 16) == (4, 36, 121, 225, 361, 529, 784,
                                         1024)
    # 4x4: linspace(2,8,8) hits x.5 values where MATLAB round() and
    # banker's rounding differ — pins the rounding convention too
    assert probe_budget_grid(4, 4) == (4, 9, 16, 25, 25, 36, 49, 64)


def test_cli_recover_uses_reference_m_grid(capsys, tmp_path):
    """recover without --m-grid sweeps the reference probe-budget grid."""
    import jax
    import twoace as t2
    from twoace.models import generate_channel
    from twoace.sensing.codebooks import random_codebook, kron_probe_rows

    cfg = t2.ArrayConfig(nt=4, nr=4)
    key = jax.random.PRNGKey(5)
    ch = generate_channel(key, cfg, t2.ChannelConfig(n_paths=1, rician_k=0),
                          batch=1)
    tx = random_codebook(jax.random.fold_in(key, 1), 8, cfg.nt).rows()
    rx = random_codebook(jax.random.fold_in(key, 2), 8, cfg.nr).rows()
    rows = np.asarray(kron_probe_rows(
        tx.reshape(1, 8, cfg.nt).repeat(8, 0), rx)).reshape(-1, cfg.n)
    amp = np.abs(rows @ np.asarray(ch.vec_h[0])) + 1e-9
    rss_dbm = 10 * np.log10(np.maximum(amp ** 2 * 1000, 1e-30))
    probes = tmp_path / "probes.npz"
    np.savez(probes, cb_rows=rows, rss_dbm=rss_dbm)
    res = _run(capsys, ["recover", *TINY, "--probes", str(probes),
                        "--method", "a2only"])
    assert res["m_grid"] == [4, 9, 16, 25, 25, 36, 49, 64]


def test_multires_tier_thresholds_and_offsets():
    """Tier selection (ref: multiresolution.m:111-112,137-143): M <= 96
    draws from tier-1 rows [0, 1984); M <= 256 from tier-2 rows
    [1984, 5952); larger M from tier-3 rows [5952, ...)."""
    import jax
    from twoace.config import MULTIRES_SEPARATION, MULTIRES_THRESHOLDS
    from twoace.pipeline.recovery import CampaignConfig, _pick_m_indices

    assert MULTIRES_THRESHOLDS == (96, 256)
    assert MULTIRES_SEPARATION == (1984, 3968, 3968)

    cc = CampaignConfig(multires=True)
    key = jax.random.PRNGKey(0)
    total = 1984 + 3968 + 3968
    i1 = np.asarray(_pick_m_indices(key, 96, total, cc))
    assert i1.min() >= 0 and i1.max() < 1984 and len(set(i1)) == 96
    i2 = np.asarray(_pick_m_indices(key, 97, total, cc))
    assert i2.min() >= 1984 and i2.max() < 5952
    i2b = np.asarray(_pick_m_indices(key, 256, total, cc))
    assert i2b.min() >= 1984 and i2b.max() < 5952
    i3 = np.asarray(_pick_m_indices(key, 257, total, cc))
    assert i3.min() >= 5952 and i3.max() < total


def test_vs_sr_measurements_needed_semantics(monkeypatch):
    """vs-sr picks the grid point whose MAEE is CLOSEST to each target
    (argmin |MAEE - target|, VS_SR_par.m:118-119 — not first-to-reach),
    reported as TOTAL measurements Mt*Mr, with per-range (M, G) grids from
    the reference's table (VS_SR_par.m:76-99)."""
    import jax
    from twoace.pipeline import simulation as sim_mod

    # MAEE curves per range, shaped like the reference's table grids:
    # range 20 -> M (2,3,4,5); range 30 -> M (4,5,6,7)
    maee = {20.0: [2.0, 0.9, 0.55, 0.3], 30.0: [1.4, 1.05, 0.7, 0.62]}
    calls = []

    def fake_cell(key, sim, mt, mr, sr):
        calls.append((sr, mt, mr, sim.array.grid_t))
        j = len([c for c in calls if c[0] == sr]) - 1
        return ({"a2": 0.1}, {"a2": maee[sr][j]}, {"a2": np.zeros(2)})

    monkeypatch.setattr(sim_mod, "_one_cell", fake_cell)
    res = sim_mod.measurements_needed_vs_range(
        jax.random.PRNGKey(0), [20.0, 30.0], maee_targets=(0.6, 1.0))
    # range 20: closest to 0.6 is M=4 (0.55) -> 16; closest to 1.0 is
    # M=3 (0.9) -> 9.  range 30: closest to 0.6 is M=7 (0.62) -> 49;
    # closest to 1.0 is M=5 (1.05) -> 25.
    np.testing.assert_array_equal(res.m_needed["a2"],
                                  [[16.0, 9.0], [49.0, 25.0]])
    # the dictionary size G follows the reference's per-point table
    assert [c[3] for c in calls if c[0] == 20.0] == [25, 35, 45, 55]
    assert [c[3] for c in calls if c[0] == 30.0] == [25, 40, 55, 60]
    # directional mode: mt = mr = per-side beam count
    assert [c[1] for c in calls if c[0] == 20.0] == [2, 3, 4, 5]
