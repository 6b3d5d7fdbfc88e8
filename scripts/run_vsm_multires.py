#!/usr/bin/env python
"""Multi-resolution accuracy artifact: A2 through tier-aware multires
sampling vs A2 through plain random probing at equal M.

The paper's namesake capability (ref: channel_recovery_ADMM_v2_simulation_
multiresolution.m:111-112,137-143 + main/main.py:317-394): small probe
budgets sample the COARSE tier of the 3-tier multires codebook (tier-1
rows share one phase bit per 4-antenna hardware group, so its rows probe a
16-dim coarse projection of the 256-dim channel), medium budgets the
2-group tier, large budgets the full-resolution tier.

Both arms measure synthetic Eq.-23 channels through SHIPPED real-hardware
probe rows:
  - multires arm: codebook/codebook_mat/random_probe_cb_16x16_multires_
    actual.mat (9920 x 256, the calibration-folded matrix the hardware
    actually applies), sampled tier-aware by pipeline.recovery.
    _pick_m_indices (thresholds 96/256, offsets 1984/3968/3968);
  - random arm: codebook/codebook_mat/random_probe_cb_16x16.mat
    (3968 x 256 full-resolution rows), sampled uniformly (A2only.m:137).

Per (M, arm, trial): fresh channel + row subset + measurement noise at
SNR 20 dB; solve with the production A2 pair solver on the accelerator.
Writes VSM_multires_r04.json with per-point mean/std over trials.

Run: python scripts/run_vsm_multires.py [trials]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")
jax.config.update("jax_compilation_cache_dir", _CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

REF = "/root/reference/codebook/codebook_mat"
M_GRID = (4, 36, 121, 225, 361, 529, 784, 1024)   # A2only.m:110-111
SNR_DB = 20.0
NT = NR = 16
N = NT * NR


def load_cbs():
    import scipy.io as sio

    cb_mr = sio.loadmat(os.path.join(
        REF, "random_probe_cb_16x16_multires_actual.mat"))["cb"]
    cb_rd = sio.loadmat(os.path.join(
        REF, "random_probe_cb_16x16.mat"))["cb"]
    # unit row-power normalization (rows are unit-modulus 16x16 krons)
    return cb_mr / np.sqrt(N), cb_rd / np.sqrt(N)


def gen_channels(key, trials):
    from twoace.config import ArrayConfig, ChannelConfig
    from twoace.models.channel import generate_channel

    cfg = ArrayConfig(nt=NT, nr=NR)
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=3, rician_k=0),
                          batch=trials)
    return np.asarray(ch.vec_h)


def main():
    from twoace.config import AdmmConfig, ArrayConfig
    from twoace.pipeline.recovery import CampaignConfig, _pick_m_indices
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import solve_lowrank_multi_pair

    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    cb_mr, cb_rd = load_cbs()
    cfg = ArrayConfig(nt=NT, nr=NR)
    admm = AdmmConfig(maxiter=500)
    cc_mr = CampaignConfig(array=cfg, multires=True)
    cc_rd = CampaignConfig(array=cfg, multires=False)

    # channel generation is complex-dtype -> host/CPU; solves go to the
    # default accelerator through the pair representation
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        vec_h = gen_channels(jax.random.PRNGKey(7), trials)

    rng = np.random.default_rng(7)
    dev = jax.devices()[0]

    def solve_batch(rows_list, b_list):
        """Vmapped pair solve of per-trial (rows, b) with one shared shape."""
        ar = jnp.asarray(np.stack([r.real for r in rows_list]), jnp.float32)
        ai = jnp.asarray(np.stack([r.imag for r in rows_list]), jnp.float32)
        bb = jnp.asarray(np.stack(b_list), jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(3), len(rows_list))
        ar, ai, bb = (jax.device_put(v, dev) for v in (ar, ai, bb))

        def one(k, re, im, b):
            res = solve_lowrank_multi_pair(k, Pair(re, im), b, NT, NR, admm)
            return res.x.re, res.x.im, res.quality

        xr, xi, q = jax.vmap(one)(keys, ar, ai, bb)
        return np.asarray(xr) + 1j * np.asarray(xi), np.asarray(q)

    def nmse_db(x, h):
        c = np.vdot(x, h) / max(np.vdot(x, x).real, 1e-30)
        return 10 * np.log10(max(
            np.linalg.norm(h - c * x) ** 2 / np.linalg.norm(h) ** 2, 1e-30))

    out = {"multires": [], "random": []}
    raw = {"multires": [], "random": []}
    for mi, m in enumerate(M_GRID):
        for arm, cb, cc in (("multires", cb_mr, cc_mr),
                            ("random", cb_rd, cc_rd)):
            rows_l, b_l = [], []
            for t in range(trials):
                k = jax.random.fold_in(jax.random.PRNGKey(1000 + mi), t)
                with jax.default_device(cpu):
                    idx = np.asarray(_pick_m_indices(k, m, cb.shape[0], cc))
                rows = cb[idx]
                y = rows @ vec_h[t]
                sig_p = np.mean(np.abs(y) ** 2)
                noise = (rng.normal(size=m) + 1j * rng.normal(size=m)) \
                    * np.sqrt(sig_p * 10 ** (-SNR_DB / 10) / 2)
                b_l.append(np.abs(y + noise))
                rows_l.append(rows)
            xs, q = solve_batch(rows_l, b_l)
            vals = [nmse_db(xs[t], vec_h[t]) for t in range(trials)]
            raw[arm].append([round(float(v), 2) for v in vals])
            out[arm].append({"m": m,
                             "nmse_db_mean": round(float(np.mean(vals)), 2),
                             "nmse_db_std": round(float(np.std(vals)), 2),
                             "quality_mean": round(float(np.mean(q)), 3)})
            print(f"M={m} {arm}: {np.mean(vals):.1f} dB "
                  f"(std {np.std(vals):.1f})", flush=True)

    res = {
        "config": {"nt": NT, "nr": NR, "paths": 3, "snr_db": SNR_DB,
                   "trials": trials, "maxiter": admm.maxiter,
                   "m_grid": list(M_GRID),
                   "multires_cb": "random_probe_cb_16x16_multires_actual.mat",
                   "random_cb": "random_probe_cb_16x16.mat",
                   "tier_rule": "multiresolution.m:111-112,137-143 via "
                                "pipeline.recovery._pick_m_indices"},
        "curves": out,
        "per_trial_nmse_db": raw,
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "VSM_multires_r04.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: [p["nmse_db_mean"] for p in v]
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
