"""chip_smoke.py and the device helpers it stands on, exercised on the CPU.

The GPU run itself only happens on a card; here the script must refuse to
run, and its formatters, parsers, phase builders and comparison helpers
are run at tiny sizes on CPU devices.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import jax
import pytest

import chip_smoke as cs
from twoace.config import AdmmConfig
from twoace.utils import device as dev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _run(args, cwd, extra_env=None, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("XLA_FLAGS",) + tuple(drop):
        env.pop(k, None)
    env.update(extra_env or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


# ------------------------------------------------------- refusing to run

@pytest.mark.parametrize("args", [[], ["--mesh4"]])
def test_refuses_without_gpu(args):
    """No accelerator: non-zero exit and no ok line, never a CPU fallback."""
    p = _run([SMOKE] + args, cwd=ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_fails_alone_in_a_directory(tmp_path):
    """Copied out of the checkout it cannot import the program."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    p = _run(["chip_smoke.py"], cwd=str(tmp_path),
             extra_env={"PYTHONPATH": ""})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


# -------------------------------------------------------------- last line

@pytest.mark.parametrize("device", [
    {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    {"platform": "gpu", "kind": "x", "count": 1, "extra": "dropped"},
])
def test_ok_line_format(device):
    line = cs.ok_line(device)
    assert "\n" not in line
    got = json.loads(line)
    assert got == {"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}
    assert line.startswith('{"ok": true, "device": {"platform": "gpu"')


# ------------------------------------------------------ nvidia-smi parser

@pytest.mark.parametrize("text, want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W",
     [("NVIDIA H100 80GB HBM3", "500.00 W")]),
    ("NVIDIA H100 80GB HBM3, 700.00 W\n" * 4 + "\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")] * 4),
    ("NVIDIA H100 PCIe, [N/A]\n", [("NVIDIA H100 PCIe", "[N/A]")]),
])
def test_parse_nvidia_smi(text, want):
    cards = dev.parse_nvidia_smi(text)
    assert [(c["name"], c["power_limit"]) for c in cards] == want


@pytest.mark.parametrize("text", ["", "\n\n", "NVIDIA H100 no limit",
                                  ", 700.00 W"])
def test_parse_nvidia_smi_rejects(text):
    with pytest.raises(ValueError):
        dev.parse_nvidia_smi(text)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        dev.require_gpu()


def test_jax_device_triple():
    d = dev.jax_device()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


# ------------------------------------------------------------ cache place

@pytest.mark.parametrize("env_value", [None, "/some/where/cache"])
def test_compile_cache_dir(monkeypatch, env_value):
    import twoace

    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
        want = env_value
    assert twoace.compile_cache_dir() == want


@pytest.mark.parametrize("env_value", [None, "CACHE_HERE"])
def test_cache_placed_on_import(tmp_path, env_value):
    """A fresh process that imports the package uses the variable's
    directory when set (and sets no other), else <checkout>/.jax_cache."""
    extra = {"PYTHONPATH": ROOT}
    code = ("import jax, twoace, bench;"
            "print(jax.config.jax_compilation_cache_dir)")
    if env_value is not None:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_value)
    p = _run(["-c", code], cwd=str(tmp_path), extra_env=extra,
             drop=("JAX_COMPILATION_CACHE_DIR",))
    assert p.returncode == 0, p.stderr
    want = (str(tmp_path / env_value) if env_value is not None
            else os.path.join(ROOT, ".jax_cache"))
    assert p.stdout.strip().splitlines()[-1] == want


# ---------------------------------------------------- problems & helpers

def test_build_problem_is_consistent():
    ap, b, x = cs.build_problem(4, 4, 48, 3, seed=0)
    assert ap.re.shape == (48, 16) and b.shape == (3, 48)
    a = np.asarray(ap.re) + 1j * np.asarray(ap.im)
    np.testing.assert_allclose(np.asarray(b), np.abs(x @ a.T), rtol=1e-5)
    # 2-bit phases, unit-modulus rows scaled by 1/sqrt(n)
    np.testing.assert_allclose(np.abs(a) * 4.0, 1.0, rtol=1e-6)
    # two paths: the 4x4 channel matrix has rank 2
    h = x[0].reshape(4, 4)
    s = np.linalg.svd(h, compute_uv=False)
    assert s[2] < 1e-8 * s[0]


@pytest.mark.parametrize("phase", [0.0, 1.0, -2.5])
def test_nmse_db_is_phase_invariant(phase):
    rng = np.random.default_rng(1)
    t = rng.normal(size=(2, 8)) + 1j * rng.normal(size=(2, 8))
    assert (cs.nmse_db(t * np.exp(1j * phase) * 3.0, t) < -250).all()
    noisy = t + 0.1 * (rng.normal(size=t.shape) + 0j)
    assert (cs.nmse_db(noisy * np.exp(1j * phase), t) > -40).all()


@pytest.mark.parametrize("stats, ok", [
    ({"median_nmse_db": -90.0, "min_quality": 1.0}, True),
    ({"median_nmse_db": -59.0, "min_quality": 1.0}, False),
    ({"median_nmse_db": -90.0, "min_quality": 0.98}, False),
])
def test_check_accuracy(stats, ok):
    if ok:
        cs.check_accuracy("x", stats)
    else:
        with pytest.raises(cs.CheckFailed):
            cs.check_accuracy("x", stats)


def test_report_prints_card_beside_each_number(capsys):
    rep = cs.Report(card="NVIDIA H100 80GB HBM3, 700.00 W")
    rep.line("phase-a", rate=1.5, n=3)
    out = capsys.readouterr().out.strip()
    assert out == "[phase-a] rate=1.5 n=3 | NVIDIA H100 80GB HBM3, 700.00 W"
    assert rep.results == {"phase-a": {"rate": 1.5, "n": 3}}


# --------------------------------------------------- phases, tiny, on CPU

def test_batch_phase_tiny():
    ap, b, x = cs.build_problem(4, 4, 64, 2, seed=3)
    stats = cs.batch_phase(ap, b, x, 4, 4, AdmmConfig(maxiter=80,
                                                      n_restarts=1))
    assert stats["batch"] == 2
    for k in ("recoveries_per_s", "seconds_per_call", "iters_per_instance",
              "median_nmse_db", "worst_nmse_db", "min_quality"):
        assert np.isfinite(stats[k]), k
    assert stats["worst_nmse_db"] >= stats["median_nmse_db"]
    assert stats["median_nmse_db"] < -10.0


def test_single_phase_tiny():
    ap, b, x = cs.build_problem(4, 4, 64, 1, seed=4)
    one = cs.single_phase(ap, b[0], x[0], 4, 4,
                          AdmmConfig(maxiter=80, n_restarts=1), reps=2)
    assert one["ms_per_solve"] > 0 and one["iters"] > 0
    assert one["nmse_db"] < -10.0


@pytest.mark.parametrize("nt, m, r", [(4, 64, 4), (4, 48, 6)])
def test_trajectory_deviation_tiny(nt, m, r):
    """float32 pair ADMM against the float64 reference: on the CPU f32
    products are exact, so the same tolerance as on the card holds."""
    dev32 = cs.trajectory_deviation(nt, nt, m, r, 10, "float32")
    assert dev32 <= cs.TRAJ_TOL_F32


def test_testbed_campaign_and_cpu_parity():
    """The testbed phase on a tiny campaign: the estimate covers the
    reference M grid and meets the CPU test's bound, and the top budget's
    recovery on the default and on the explicit CPU device agrees inside
    the stated parity bound."""
    from twoace.config import probe_budget_grid

    tb, runner, ch = cs.testbed_campaign(4, 4, 8, 8)
    assert tb["probes"] == 64
    assert tb["m_grid"] == list(probe_budget_grid(4, 4))
    assert tb["nmse"] < cs.TESTBED_NMSE_BOUND
    here = cs.testbed_on_device(runner, ch, tb["m_grid"][-1])
    on_cpu = cs.testbed_on_device(runner, ch, tb["m_grid"][-1],
                                  jax.devices("cpu")[0])
    assert abs(here - on_cpu) <= cs.TESTBED_PARITY_DB


def test_cli_testbed_in_process():
    """The CLI's testbed subcommand in this process, at the campaign
    defaults the smoke run uses: it sweeps the reference M grid."""
    from twoace.config import probe_budget_grid

    summary = cs.cli_testbed(["testbed", "--nt", "4", "--nr", "4",
                              "--rounds", "8", "--sectors", "8",
                              "--paths", "2", "--noise-dbm", "0",
                              "--platform", "cpu"])
    assert summary["cmd"] == "testbed"
    assert summary["m_grid"] == list(probe_budget_grid(4, 4))
    assert np.isfinite(summary["nmse_db_final"])


# ------------------------------------------------------------------ mesh4

def _fake(n, platform="gpu"):
    return [types.SimpleNamespace(platform=platform) for _ in range(n)]


@pytest.mark.parametrize("devices", [_fake(1), _fake(2), _fake(3),
                                     _fake(5), _fake(8), _fake(4, "cpu")])
def test_mesh4_refuses_other_counts(devices):
    with pytest.raises(cs.CheckFailed, match="exactly 4 GPUs"):
        cs.check_mesh4_devices(devices)


def test_mesh4_accepts_four_gpus():
    cs.check_mesh4_devices(_fake(4))


def test_mesh4_phase_on_virtual_cpu_devices(capsys):
    """The 4-card phase on 4 of the 8 virtual CPU devices at a tiny size."""
    rep = cs.Report(card="cpu")
    cs.mesh4_phase(rep, nt=4, m=64, batch=2)
    assert set(rep.results) == {"mesh4-one-card", "mesh4-batch1x-rows4",
                                "mesh4-batch2x-rows2"}


def test_main_phases_tiny(capsys):
    """Every one-card phase and check of the smoke run, end to end, at a
    tiny width on the CPU (the card runs the same code at Sizes())."""
    rep = cs.Report(card="cpu")
    cs.main_phases(rep, cs.Sizes(nt=4, m=64, batch=4, nt_ura=4, m_ura=96,
                                 batch_ura=2, rounds=8, sectors=8))
    assert list(rep.results) == [
        "batch-cold", "batch-warm80", "full-ura", "single",
        "trajectory-float32", "trajectory-default", "testbed",
        "cli-testbed", "testbed-vs-cpu"]
    out = capsys.readouterr().out
    assert all(line.endswith("| cpu") for line in out.strip().splitlines()
               if line.startswith("["))
