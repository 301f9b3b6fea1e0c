"""The port's audio frontend and log-mel plain version against the JAX
package, on the CPU, from numpy-seeded waveforms.

Tolerances, in the log domain: 1e-4 between two f32 computations of the
same DFT (rfft against the window-folded DFT products sum in different
orders); the JAX fused kernel in interpret mode keeps its bf16x3 split
products, so it is held to 2e-3 as tests/test_audio.py holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.audio import frontend as jfe
from tethys_tpu.audio import pallas_logmel
from tethys_tpu_torch.audio import frontend, logmel

torch.set_num_threads(2)


def _wave(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_constants_equal_jax():
    np.testing.assert_array_equal(frontend.hann_window(400),
                                  jfe.hann_window(400))
    for n_mels in (80, 128, 8):
        np.testing.assert_array_equal(
            frontend.linear_to_mel_weight_matrix(n_mels, 201, 16000, 0.0,
                                                 8000.0),
            jfe.linear_to_mel_weight_matrix(n_mels, 201, 16000, 0.0, 8000.0))
    cos_m, sin_m = logmel.dft_matrices(400)
    j_cos, j_sin = pallas_logmel._dft_matrices(400, 512)
    np.testing.assert_array_equal(cos_m, j_cos[:400])
    np.testing.assert_array_equal(sin_m, j_sin[:400])
    assert not j_cos[400:].any() and not j_sin[400:].any()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_log_mel_matches_jax_frontend(n_mels):
    wave = _wave(0, 2, 16000)
    want = np.asarray(jfe.extract_fbank_features(jnp.asarray(wave),
                                                 n_mels=n_mels))
    got = logmel.fused_log_mel(torch.from_numpy(wave), n_mels=n_mels)
    assert got.shape == want.shape == (2, 98, n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = frontend.extract_fbank_features(torch.from_numpy(wave),
                                            n_mels=n_mels)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_log_mel_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_logmel, "_INTERPRET", True)
    wave = _wave(1, 2, 12000)
    want = np.asarray(pallas_logmel.fused_log_mel(jnp.asarray(wave)))
    got = logmel.fused_log_mel(torch.from_numpy(wave))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("seconds,n_frames", [(1.0, 120), (1.0, 64)])
def test_prepare_input_features_matches_jax(seconds, n_frames):
    """Padding with log(1e-6) past the audio (98 frames -> 120) and
    trimming (-> 64), in the [B, n_mels, T] encoder layout."""
    wave = _wave(2, int(16000 * seconds))
    want = np.asarray(jfe.prepare_input_features(jnp.asarray(wave),
                                                 n_frames=n_frames))
    got = frontend.prepare_input_features(torch.from_numpy(wave),
                                          n_frames=n_frames)
    assert got.shape == want.shape == (1, 80, n_frames)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    batched = frontend.prepare_input_features(
        torch.from_numpy(np.stack([wave, wave])), n_frames=n_frames)
    np.testing.assert_array_equal(batched[1].numpy(), got[0].numpy())


def test_thirty_seconds_is_2998_frames_padded_to_3000():
    wave = torch.from_numpy(_wave(3, 16000 * 30))
    feats = frontend.prepare_input_features(wave, n_frames=3000, n_mels=80)
    assert feats.shape == (1, 80, 3000)
    assert (feats[0, :, :2998] > np.log(1e-6) + 1).all()
    np.testing.assert_allclose(feats[0, :, 2998:].numpy(), np.log(1e-6),
                               rtol=1e-6)


def _frames_from_framing(waveform, framing):
    """The frames the kernel reads, rebuilt from its framing arguments."""
    storage = torch.as_strided(waveform, (waveform.untyped_storage().nbytes()
                                          // waveform.element_size(),), (1,), 0)
    return torch.as_strided(
        storage, (framing.rows, framing.frames_per_row, framing.n_fft),
        (framing.row_stride, framing.hop, 1), framing.offset)


@pytest.mark.parametrize("layout", ["batch", "stream_windows"])
def test_kernel_framing_rebuilds_frame_signal(layout):
    """The kernel's arguments (base offset, row stride, rows, frames per
    row, n_fft, hop) address the frames frame_signal gives: for a [B, T]
    batch, and for stream_log_mel's overlapping windows (rows W samples
    apart in one padded signal, here a view 3 samples into its storage)."""
    if layout == "batch":
        wave = torch.from_numpy(_wave(4, 3, 16000))
    else:
        signal = torch.from_numpy(_wave(5, 3 + 2 * 4000 + 240))[3:]
        wave = signal.unfold(0, 4000 + 240, 4000)
        assert wave.storage_offset() == 3 and not wave.is_contiguous()
    framing = logmel.kernel_framing(wave, 400, 160)
    want = frontend.frame_signal(wave, 400, 160)
    assert framing.rows * framing.frames_per_row == want.shape[0] * want.shape[1]
    got = _frames_from_framing(wave, framing)
    assert torch.equal(got.reshape(want.shape), want)


def test_kernel_framing_refuses_rows_of_two_strides():
    """Leading dimensions that are not rows of one stride give None (the
    wrapper then copies); so does a waveform whose samples are not adjacent."""
    wave = torch.from_numpy(_wave(6, 4, 3, 2000))
    assert logmel.kernel_framing(wave, 400, 160) is not None
    assert logmel.kernel_framing(wave[:, :2], 400, 160) is None
    assert logmel.kernel_framing(wave[..., ::2], 400, 160) is None
    framing = logmel.kernel_framing(wave[1:3], 400, 160)
    assert framing.offset == 3 * 2000 and framing.row_stride == 2000
    assert framing.rows == 6


def _tf32_bits(x, add):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(add)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_b(x):
    """The kernel's split of a B operand (frames, power) in registers: hi
    rounded to TF32 by the integer add (as logmel.split_tf32), lo = x - hi,
    whose low 13 bits the tensor cores ignore."""
    hi = _tf32_bits(x, 0x1000)
    return hi, _tf32_bits(x - hi, 0)


def _mma_tf32(b, a, c):
    """c + b @ a for one m16n8k8 step, b [F, 8] and a [8, N] TF32 values, c
    [F, N] f32, modelled as the tensor cores add: the products exact (two
    11-bit significands fit f32), every addend cut toward zero to the 24-bit
    grid of the largest, the sum cut toward zero to f32."""
    p = b[:, None, :] * a.T[None]                          # [F, N, 8]
    big = np.maximum(np.abs(p).max(axis=2), np.abs(c))
    exp = (big.view(np.int32) >> 23) & 0xFF
    inv = (np.clip(277 - exp, 1, 254) << 23).view(np.float32)  # 1 / grid
    p *= inv[..., None]
    np.trunc(p, out=p)
    total = p.sum(axis=2, dtype=np.float64) + np.trunc(c * inv)
    cut = total / inv                                      # exact, f64
    return (cut.view(np.int64) & ~np.int64((1 << 29) - 1)).view(
        np.float64).astype(np.float32)


def _product_3xtf32(b, a):
    """b @ a as the kernel forms it: a split on the host by
    logmel.split_tf32, b by _split_b; per step of 8 taps, a_lo b_hi, a_hi
    b_lo, a_hi b_hi through the tensor cores from a sum of 0 (_mma_tf32),
    that sum added to the result by an f32 add."""
    k = -(-b.shape[1] // 8) * 8
    b = np.pad(b, ((0, 0), (0, k - b.shape[1])))
    a = np.pad(a, ((0, k - a.shape[0]), (0, 0)))
    a_hi, a_lo = logmel.split_tf32(a)
    b_hi, b_lo = _split_b(b)
    out = np.zeros((b.shape[0], a.shape[1]), np.float32)
    for s in range(0, k, 8):
        step = slice(s, s + 8)
        part = _mma_tf32(b_hi[:, step], a_lo[step], np.zeros_like(out))
        part = _mma_tf32(b_lo[:, step], a_hi[step], part)
        out += _mma_tf32(b_hi[:, step], a_hi[step], part)
    return out


def _folded(frames):
    """(x[n] + x[N - n], x[n] - x[N - n]) for n = 0 .. N / 2 (mod N), in
    f32, as the kernel forms them."""
    n = frames.shape[-1]
    mirror = (n - np.arange(n // 2 + 1)) % n
    head = frames[:, :n // 2 + 1]
    return head + frames[:, mirror], head - frames[:, mirror]


def test_folded_dft_is_the_dft():
    """The kernel's folded taps (the Hann window's symmetry) give the same
    re and im as the 400-tap products, to f32 rounding."""
    frames = np.lib.stride_tricks.sliding_window_view(
        _wave(8, 16000), 400)[::160].astype(np.float64)
    cos_m, sin_m = logmel.dft_matrices(400)
    cos_f, sin_f = logmel.folded_dft_matrices(400)
    assert cos_f.shape == sin_f.shape == (201, 201)
    total, diff = _folded(frames)
    np.testing.assert_allclose(total @ cos_f, frames @ cos_m, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(diff @ sin_f, frames @ sin_m, rtol=0,
                               atol=1e-5)


def test_3xtf32_log_mel_holds_the_kernel_gates(monkeypatch):
    """The kernel's 3xTF32 numerics on its folded taps (_product_3xtf32),
    emulated on the CPU on 30 s of seeded audio: within 1e-4 of a float64 reference (so phase
    3's 1e-3 against the exact f32 plain version holds) and within the 2e-3
    that holds the plain version to JAX's interpret-mode fused_log_mel."""
    wave = _wave(7, 1, 16000 * 30)
    frames = np.lib.stride_tricks.sliding_window_view(wave[0], 400)[::160]
    assert frames.shape == (2998, 400)
    cos_m, sin_m = logmel.dft_matrices(400)
    mel_m = frontend.linear_to_mel_weight_matrix(80, 201, 16000, 0.0, 8000.0)

    re, im = frames @ cos_m.astype(np.float64), frames @ sin_m.astype(np.float64)
    want64 = np.log((re * re + im * im) @ mel_m.astype(np.float64) + 1e-6)
    cos_f, sin_f = logmel.folded_dft_matrices(400)
    total, diff = _folded(frames)
    re = _product_3xtf32(total, cos_f)
    im = _product_3xtf32(diff, sin_f)
    power = (re * re + im * im).astype(np.float32)
    got = np.log(_product_3xtf32(power, mel_m) + np.float32(1e-6))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want64, rtol=0, atol=1e-4)

    monkeypatch.setattr(pallas_logmel, "_INTERPRET", True)
    pallas = np.asarray(pallas_logmel.fused_log_mel(jnp.asarray(wave)))[0]
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)


def test_kernel_operands_are_the_matrices_split_in_fragment_order():
    """The kernel's constant operands: hi + lo gives back the folded Cf^T,
    Sf^T and mel^T (to 2^-21 relative), each in mma.m16n8k8's A-fragment order, and
    the mel tiles' step ranges hold every nonzero weight."""
    dft, mel, steps = (x.numpy() for x in logmel._kernel_operands(
        400, 80, 16000, torch.device("cpu")))
    cos_m, sin_m = logmel.folded_dft_matrices(400)
    mel_m = frontend.linear_to_mel_weight_matrix(80, 201, 16000, 0.0, 8000.0)

    def unfragment(frag):  # [mt, ks, 32, 4] -> [16 mt, 8 ks]
        mt, ks = frag.shape[:2]
        a = frag.reshape(mt, ks, 8, 4, 2, 2)       # [mt, ks, g, t, hi4, hi8]
        return a.transpose(0, 5, 2, 1, 4, 3).reshape(mt * 16, ks * 8)

    for m, (hi, lo) in ((cos_m, (0, 1)), (sin_m, (2, 3))):
        got = unfragment(dft[:, :, hi]) + unfragment(dft[:, :, lo])
        assert got.shape == (208, 208)
        np.testing.assert_allclose(got[:201, :201], m.T, rtol=2 ** -20,
                                   atol=1e-30)
        assert not got[201:].any() and not got[:, 201:].any()
    got = unfragment(mel[:, :, 0]) + unfragment(mel[:, :, 1])
    np.testing.assert_allclose(got[:80, :201], mel_m.T, rtol=2 ** -20)
    for mt, (lo, hi) in enumerate(steps):
        tile = got[16 * mt:16 * mt + 16]
        assert not tile[:, :8 * lo].any() and not tile[:, 8 * hi:].any()
    hi, lo = logmel.split_tf32(cos_m)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
