"""The roofline work functions (work.py) against hand counts."""

import json
from pathlib import Path

import pytest

from tethys_bench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_flash_site_by_hand():
    # B*H 2, Tq = Tk = 4, D 8, bf16: one product 2 * 2 * 4 * 4 * 8 = 512.
    # Forward: Q, K, V read (3 * 128 bytes), O written (128), lse (2 * 4
    # f32 = 32).  Backward: Q, K, V, O, dO read (5 * 128), lse (32),
    # dQ, dK, dV written (3 * 128).
    fwd, bwd = work.flash_work(2, 4, 4, 8)
    assert fwd == work.Work(1024.0, 544)
    assert bwd == work.Work(2560.0, 1056)


def test_flash_bounds_match_the_kernel_table():
    # PERF.md's kernel table: B*H 128, 1500^2, D 64: forward 0.0745 ms and
    # backward 0.1864 ms by operations at 989 TFLOP/s.
    fwd, bwd = work.flash_work(128, 1500, 1500, 64)
    assert fwd.seconds() * 1e3 == pytest.approx(0.0745, abs=5e-5)
    assert bwd.seconds() * 1e3 == pytest.approx(0.1864, abs=5e-5)


def test_group_norm_by_hand():
    # [2, 10, 4] bf16 = 160 bytes: x read and y written; x, dy read and dx
    # written.
    assert work.group_norm_work(2, 10, 4) == [work.Work(0.0, 320),
                                               work.Work(0.0, 480)]


def test_whisper_sites():
    with open(CONFIGS / "whisper-base.json") as fh:
        cfg = json.load(fh)
    sites = work.whisper_flash_work(cfg, 128, 3000, 100)
    # 6 encoder self-attention and 6 cross-attention sites, forward and
    # backward each; decoder self-attention (100 x 100) stays plain.
    assert len(sites) == 24
    assert sites[0] == work.flash_work(1024, 1500, 1500, 64)[0]
    assert sites[12] == work.flash_work(1024, 100, 1500, 64)[0]


def test_wav2vec2_group_norms():
    with open(CONFIGS / "wav2vec2-base.json") as fh:
        cfg = json.load(fh)
    norms = work.wav2vec2_group_norm_work(cfg, 32, 250000)
    lengths = [50000, 25000, 12500, 6250, 3125, 1563, 782]
    assert [w.bytes for w in norms[::2]] == [2 * 32 * t * 512 * 2
                                            for t in lengths]
