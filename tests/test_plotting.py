"""Figure-layer smoke tests (E7): every plot function renders to a file."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from twoace.config import ArrayConfig, ChannelConfig
from twoace.models import generate_channel
from twoace.ops.prox import profile_ladder
from twoace.utils import plotting

pytest.importorskip("matplotlib")


def test_all_plots_render(tmp_path, key):
    cfg = ArrayConfig(nt=8, nr=8)
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=2, rician_k=0),
                          batch=4, dtype=jnp.complex128)

    p1 = plotting.plot_error_vs_grid(
        [4, 16, 64], {"a2": np.array([0.5, 0.05, 0.01]),
                      "phaselift": np.array([0.9, 0.2, 0.05])},
        xlabel="measurements M", path=str(tmp_path / "err.png"))
    p2 = plotting.plot_nmse_cdf(
        {"a2": np.random.default_rng(0).uniform(1e-3, 1e-1, 50)},
        str(tmp_path / "cdf.png"))
    p3 = plotting.plot_beam_pattern(np.exp(1j * np.zeros((4, 8))), cfg.k_d,
                                    str(tmp_path / "beam.png"))
    p4 = plotting.plot_spectral_profile(
        ch.h_matrix, str(tmp_path / "profile.png"),
        ladders={"A2": profile_ladder(8, 8, 100, 64, False)})
    p5 = plotting.plot_beamforming_rss({"a2": -50.0, "sweep": -55.0},
                                       str(tmp_path / "bf.png"))
    for p in (p1, p2, p3, p4, p5):
        assert (tmp_path / p.split("/")[-1]).stat().st_size > 1000


def test_beam_width_narrows_with_aperture(tmp_path):
    """-3 dB beamwidth shrinks as the ULA grows (physics sanity)."""
    import numpy as np
    from twoace.utils.plotting import beam_width_deg, plot_beam_width

    widths = []
    for n in (8, 16, 32):
        # broadside steering vector at 90 deg with half-wavelength spacing
        w = np.exp(1j * 2 * np.pi * 0.5 * np.cos(np.deg2rad(90.0))
                   * np.arange(n))
        width, _, gdb = beam_width_deg(w, 0.5)
        widths.append(width)
        assert gdb.max() > 0
    assert widths[0] > widths[1] > widths[2]
    out = plot_beam_width(np.exp(1j * np.zeros(16)), 0.5,
                          str(tmp_path / "bw.png"))
    assert out > 0
