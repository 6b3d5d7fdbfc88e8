"""Native RSS server + TCP provider tests (replaces wil6210_server +
fetch_rss, SURVEY §2.4 H1/H6)."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest

from twoace.sensing.tcp_provider import ServerProcess, TcpProvider

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


def test_server_roundtrip_noiseless():
    rng = np.random.default_rng(0)
    n = 16
    h = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 1e-3
    rows = (rng.normal(size=(5, n)) + 1j * rng.normal(size=(5, n)))
    with ServerProcess() as srv:
        prov = TcpProvider(port=srv.port)
        prov.set_channel(h)
        prov.set_noise(0.0)
        rss = prov.measure(rows)
        prov.close()
    expect = 10 * np.log10(np.abs(rows @ h) ** 2)
    # RSSI word quantization limits agreement to one 0.0652 dB step
    np.testing.assert_allclose(rss, expect, atol=0.04)


def test_server_noise_and_median():
    rng = np.random.default_rng(1)
    n = 8
    h = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 1e-3
    rows = rng.normal(size=(3, n)) + 0j
    with ServerProcess(n_dumps=11) as srv:
        prov = TcpProvider(port=srv.port)
        prov.set_channel(h)
        prov.set_noise(1.0, seed=7)
        r1 = prov.measure(rows)
        r2 = prov.measure(rows)
        prov.close()
    expect = 10 * np.log10(np.abs(rows @ h) ** 2)
    # median of 11 noisy dumps stays near truth; separate calls differ
    assert np.abs(r1 - expect).max() < 1.5
    assert not np.allclose(r1, r2)


def test_server_unknown_command_and_weak_signal():
    with ServerProcess() as srv:
        prov = TcpProvider(port=srv.port)
        prov.set_channel(np.zeros(4, complex))
        rss = prov.measure(np.ones((2, 4), complex))
        # zero channel -> floor RSSI word 0 -> calibration offset
        np.testing.assert_allclose(rss, -74.3875, atol=1e-6)
        # protocol error surfaces cleanly
        resp = prov._rpc({"cmd": "bogus"})
        assert "error" in resp
        prov.close()


def test_codebook_image_roundtrip(tmp_path):
    """TBRD image: create/set/get sectors, active count, module mask
    (the wil6210_brd_mod role, codebook_library.py:21-48)."""
    from twoace.sensing.brd import CodebookImage

    p = str(tmp_path / "rx.tbrd")
    img = CodebookImage.create(p, n_ant=16, n_sectors=4)
    assert img.info() == (16, 4, 4, 0xFFFFFFFF)

    rng = np.random.default_rng(0)
    phases = rng.integers(0, 4, (4, 16))
    img.set_all(phases)
    amp, back = img.get_all()
    np.testing.assert_array_equal(back, phases)
    np.testing.assert_array_equal(amp, np.full((4, 16), 7))

    img.set_beam(2, np.arange(16) % 4, amp=np.full(16, 3))
    a2, p2 = img.get_beam(2)
    np.testing.assert_array_equal(p2, np.arange(16) % 4)
    np.testing.assert_array_equal(a2, np.full(16, 3))

    img.set_beam_num(3)
    img.enable_modules(0b0101)
    assert img.info() == (16, 4, 3, 0b0101)


def test_codebook_image_detects_corruption(tmp_path):
    from twoace.sensing.brd import CodebookImage

    p = str(tmp_path / "bad.tbrd")
    img = CodebookImage.create(p, n_ant=8, n_sectors=2)
    img.set_all(np.ones((2, 8), np.uint8))
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF                       # flip a payload byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(OSError, match="checksum"):
        img.get_all()


def test_export_codebook_set(tmp_path):
    """Generator-script output shape: per-round images + txt phase table
    (ref generate_rx_codebook_16ant_random.py:44-92)."""
    from twoace.sensing.brd import (
        CodebookImage,
        export_codebook_set,
        read_phase_table,
    )

    rng = np.random.default_rng(1)
    bits = rng.integers(0, 4, (6, 8))
    paths = export_codebook_set(str(tmp_path), "rx_random", bits)
    assert len(paths) == 6
    _, back = CodebookImage(paths[2]).get_all()
    np.testing.assert_array_equal(back[0], bits[2])
    np.testing.assert_array_equal(read_phase_table(
        str(tmp_path / "rx_random.txt")), bits)
