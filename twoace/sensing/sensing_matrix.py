"""Sensing-matrix construction and beam selection.

JAX rewrite of:
  - ``Generate_Sensing_Matrix`` (mode dispatch over beam-pattern families)
    ref: main/src/generate_sensing_matrix/Generate_Sensing_Matrix.m:73-256
  - ``Generate_Sensing_Matrix_with_candidate`` (beam picking out of a given
    hardware codebook)
    ref: main/src/generate_sensing_matrix/Generate_Sensing_Matrix_with_candidate.m:1-45
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math
import jax
import jax.numpy as jnp

from ..config import ArrayConfig
from .bayes_opt import bayes_a_opt_select, noise_prior_from_vech, prior_from_channel
from .codebooks import (
    directional_beams_angular,
    directional_beams_spatial,
    directional_random_beams,
    random_sensing_rows,
    region_random_beams,
)


class SensingMatrix(NamedTuple):
    f: jax.Array                #: (nt, mt) Tx beams (zeros for random mode)
    w: jax.Array                #: (U, nr, mr) Rx combiners — NOTE: stays zero
    #: in the Random_Phase_State mode, replicating the reference where the
    #: assignment is commented out (Generate_Sensing_Matrix.m:117) and hence
    #: the combiner-colored noise is zero for that mode.
    fw: jax.Array               #: (U, mt*mr, nt*nr) measurement rows
    measurement_mat: jax.Array  #: (U, mt*mr, P) = FW @ AD


def _kron_fw(f, w):
    """FW = kron(F^T, W^H): row (i, j) = kron(F[:, i]^T, W[:, j]^H), Tx-probe
    major, Rx antenna index fastest (ref: Generate_Sensing_Matrix.m:177)."""
    rows = jnp.einsum("ti,rj->ijtr", f, jnp.conj(w))
    mt, mr = f.shape[1], w.shape[1]
    return rows.reshape(mt * mr, -1)


def generate_sensing_matrix(key, method: str, mt: int, mr: int,
                            cfg: ArrayConfig, ad,
                            aod_range=None, aoa_range=None,
                            batch: int = 1,
                            prior_k=None) -> SensingMatrix:
    """Build sensing rows for a batch of U users/instances.

    Methods (ref: Generate_Sensing_Matrix.m:84-232):
      - ``"Random_Phase_State"``: each of the mt*mr rows is an independent
        uniform 2-bit phase vector of length nt*nr (ref :109-121); rows are
        prefix-stable in the measurement count.
      - ``"Directional_Beam"``: spatial-uniform directional beams (ref :169-179)
      - ``"Directional_Beam_Angular"``: angle-uniform sectors (ref :181-190)
      - ``"Random_Beam_Bayes"``: random candidates + Bayesian A-optimal
        row-exchange selection (ref :215-218, Bayes_Beam.m)
    """
    n = cfg.n
    ad = jnp.asarray(ad)
    m = mt * mr

    if method == "Random_Phase_State":
        def per_user(i):
            return random_sensing_rows(jax.random.fold_in(key, i), m, n,
                                       cfg.phase_bit)
        fw = jax.vmap(per_user)(jnp.arange(batch))
        f = jnp.zeros((cfg.nt, mt), fw.dtype)
        w = jnp.zeros((batch, cfg.nr, mr), fw.dtype)
    elif method in ("Directional_Beam", "Directional_Beam_Angular",
                    "Directional_Random_Beam", "Region_Random_Beam"):
        if aod_range is None:
            raise ValueError("directional modes need aod_range/aoa_range")
        span = float(aod_range[1] - aod_range[0])
        if method == "Directional_Beam":
            f, w_single = directional_beams_spatial(mt, mr, cfg, span)
        elif method == "Directional_Random_Beam":
            f, w_single = directional_random_beams(key, mt, mr, cfg, span)
        elif method == "Region_Random_Beam":
            f, w_single = region_random_beams(key, mt, mr, cfg, span)
        else:
            f, w_single = directional_beams_angular(mt, mr, cfg, aod_range,
                                                    aoa_range)
        fw_single = _kron_fw(f, w_single)
        fw = jnp.broadcast_to(fw_single[None], (batch, m, n))
        w = jnp.broadcast_to(w_single[None], (batch, cfg.nr, mr))
    elif method == "Random_Beam_Bayes":
        cand = random_sensing_rows(key, max(4 * m, 256), n, cfg.phase_bit)
        sel = bayes_a_opt_select(jax.random.fold_in(key, 1), cand, m,
                                 prior_k=prior_k)
        fw_single = cand[sel]
        fw = jnp.broadcast_to(fw_single[None], (batch, m, n))
        f = jnp.zeros((cfg.nt, mt), fw.dtype)
        w = jnp.zeros((batch, cfg.nr, mr), fw.dtype)
    else:
        raise ValueError(f"unknown sensing method: {method}")

    meas_mat = jnp.einsum("umn,np->ump", fw, ad.astype(fw.dtype))
    return SensingMatrix(f=f, w=w, fw=fw, measurement_mat=meas_mat)


def directional_beam_bayes(key, mt: int, mr: int, cfg: ArrayConfig,
                           vec_h_users, snr_db: float = 0.0,
                           option: int = 2,
                           candidate_size: int = 90) -> SensingMatrix:
    """Multi-user Bayes-A-optimal probing beams over a Tx x Rx candidate kron.

    ref: main/src/generate_sensing_matrix/Directional_Beam_Bayes.m:17-57 —
    candidates are either directional sectors (``option=1``, ref :25-28) or
    random 2-bit Tx/Rx beams (``option=2``, ref :29-39), combined as
    ``kron(F^T, W^H)``; each user's prior is the diagonal noise precision
    ``db2pow(SNR) * diag(vecH_u^-1)`` (ref :41-48).  As in the reference, the
    selected rows are returned on the first user slot of ``fw`` (ref :55-56).
    """
    n = cfg.n
    m = mt * mr
    vh = jnp.asarray(vec_h_users)
    if vh.ndim == 1:
        vh = vh[None]
    batch = vh.shape[0]

    if option == 1:
        f_try, w_try = directional_beams_angular(candidate_size, candidate_size,
                                                 cfg, (-90.0, 90.0),
                                                 (-90.0, 90.0))
    else:
        k1, k2 = jax.random.split(key)
        np_levels = cfg.phase_bit ** 2
        bits_t = jax.random.randint(k1, (cfg.nt, candidate_size), 0, np_levels)
        f_try = jnp.exp(1j * bits_t * (jnp.pi / np_levels)) / math.sqrt(cfg.nt)
        bits_r = jax.random.randint(k2, (cfg.nr, candidate_size), 0, np_levels)
        w_try = jnp.exp(1j * bits_r * (jnp.pi / np_levels)) / math.sqrt(cfg.nr)
    cand = _kron_fw(f_try, w_try)                       # (cand^2, n)

    prior = noise_prior_from_vech(vh, snr_db)           # (U, n, n)
    sel = bayes_a_opt_select(jax.random.fold_in(key, 7), cand, m,
                             prior_k=prior)
    fw = jnp.zeros((batch, m, n), cand.dtype).at[0].set(cand[sel])
    return SensingMatrix(f=jnp.zeros((cfg.nt, mt), cand.dtype),
                         w=jnp.zeros((batch, cfg.nr, mr), cand.dtype),
                         fw=fw, measurement_mat=fw)


def directional_beam_bayes_v2(key, mt: int, mr: int, cfg: ArrayConfig, ad,
                              h_users, snr_db: float = 0.0,
                              n_users: Optional[int] = None):
    """Multi-user MISO Bayes beams: sub-array steering candidates, priors
    from each user's channel estimate.

    ref: main/src/generate_sensing_matrix/Directional_Beam_Bayes_v2.m:27-81 —
    the Tx array is split into ``n_users`` contiguous groups of
    ``floor(nt/U)`` antennas, each carrying the same steering vector
    (ref :36-43); candidates live in the sparse domain ``F^T AD``
    (ref :51-56); per-user priors come from ``find_K`` on the user's channel
    estimate (ref :52-55); the selected columns are 2-bit quantized
    (ref :76-78).  Returns ``(f_selected, indices)``.
    """
    from ..utils.metrics import quantize_ps

    u = n_users if n_users is not None else (
        h_users.shape[0] if jnp.asarray(h_users).ndim == 3 else 1)
    h_users = jnp.asarray(h_users)
    if h_users.ndim == 2:
        h_users = h_users[None]
    ad = jnp.asarray(ad)
    p = ad.shape[1]
    m = mt * mr

    aod_deg = jnp.arange(-90.0, 91.0)
    n_sep = cfg.nt // u
    base = jnp.exp(-1j * cfg.k_d * jnp.sin(jnp.deg2rad(aod_deg))[:, None]
                   * jnp.arange(n_sep)[None, :]) / math.sqrt(cfg.nt)
    f_try = jnp.tile(base, (1, u))[:, :cfg.nt].T            # (nt, 181)

    scale = math.sqrt(10.0 ** (snr_db / 10.0))
    cand = (scale * f_try).T @ ad.astype(f_try.dtype)       # (181, P)

    prior = jnp.stack([prior_from_channel(h_users[i % h_users.shape[0]],
                                          cfg, p)
                       for i in range(u)])
    sel = bayes_a_opt_select(jax.random.fold_in(key, 11), cand, m,
                             prior_k=prior)
    f_quant = quantize_ps(f_try, cfg.phase_bit)
    return f_quant[:, sel], sel


def pick_beams(key, method: str, m: int, cb_train,
               prior_k=None) -> jax.Array:
    """Pick M beam indices out of a measured codebook.

    ref: Generate_Sensing_Matrix_with_candidate.m:1-45 —
    ``"Random_Phase_State"`` takes the first M rows (the codebook rows are
    already random, ref :12); ``"Bayes_Beam"`` runs A-optimal selection over
    a random candidate subset (ref :37-38, Bayes_Beam.m:1-15).
    """
    num = cb_train.shape[0]
    if method == "Random_Phase_State":
        return jnp.arange(m)
    if method == "Bayes_Beam":
        cand_size = min(num, 40000)
        cand_idx = jax.random.randint(key, (cand_size,), 0, num)
        cand = cb_train[cand_idx]
        sel = bayes_a_opt_select(jax.random.fold_in(key, 1), cand, m,
                                 prior_k=prior_k)
        return cand_idx[sel]
    raise ValueError(f"unknown beam-pick method: {method}")
