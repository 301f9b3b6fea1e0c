"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips
where torch.cuda.is_available() is false (as on a CPU-only machine).
These cover the kernels' branches off the main path's shapes: head
dims 16-128, ragged sequence edges (Tq 1500 against keys padded to 1536,
Tk 2560), misaligned flash inputs, misaligned and odd-width head splits
and merges, dropout on odd lengths and misaligned views, the flash
backward with and without dropout, caches that need more than 48 KB of
shared memory, the GroupNorm statistics, apply and backward passes at
ragged T and C, far-off means, misaligned views and every cluster size,
the int8 cross-attention at odd Tk and kv_len, the fused
projections at ragged tiles on each of their routes (wgmma, weight
streaming, mma.sync, FFMA) and the boundaries between them, with their
gradients, the wrappers' refusals,
tiny Whisper and Wav2Vec2 training steps and tiny int8 long-audio serving
on the card against the CPU.  On a machine with the card and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which the card's machine
need not have; nothing here uses JAX.)
"""

import pytest
import torch

from tethys_tpu_torch.audio import logmel
from tethys_tpu_torch.audio.frontend import frame_signal
from tethys_tpu_torch.models import wav2vec2
from tethys_tpu_torch.models.whisper import create_whisper_model, greedy_generate
from tethys_tpu_torch.ops import (
    decode,
    dropout,
    flash_attention,
    group_norm,
    norms,
    qkv,
    transpose,
)
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.utils import kernel_lib

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

TINY = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4,
            decoder_layers=2, decoder_attention_heads=4, d_ff=128, n_mels=8,
            n_ctx=600, vocab_size=50, max_target_positions=16,
            decoder_start_token_id=47)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, dtype=torch.float32, scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


# bf16 flash outputs, beside their absolute tolerances: the largest
# difference from the plain version over its largest magnitude.  Rounding
# either side to bf16 moves a value by at most 2^-7 of the largest; a 10%
# scale error (a lost 1/(1-r)) or another dropout mask reads 0.1 or more.
BF16_REL_LIMIT = 0.025


def _assert_rel(got, want, name=""):
    if got.dtype != torch.bfloat16:
        return
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel <= BF16_REL_LIMIT, f"{name}: relative error {rel}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,d", [(37, 3, 16), (1, 8, 64), (5, 4, 6),
                                   (9, 2, 5), (11, 5, 3)])
def test_split_heads_exact(cuda, dtype, t, h, d):
    """16-byte vectors (d*size % 16 == 0), 4-byte words, 2-byte elements.
    At T = 1 (a decode step) the split moves no bytes: a view of x, no
    launch; split_heads_cuda, the direct launch, still copies there."""
    x = _randn(cuda, 2, t, h * d, dtype=dtype)
    before = kernel_lib.SPLIT_HEADS.launches
    got = transpose.split_heads(x, h)
    view = t == 1
    assert kernel_lib.SPLIT_HEADS.launches == before + (0 if view else 1)
    shared = got.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert shared == view
    assert torch.equal(got, transpose.plain_split_heads(x, h))
    assert torch.equal(transpose.split_heads_cuda(x, h),
                       transpose.plain_split_heads(x, h))


def test_split_heads_misaligned_input(cuda):
    """A contiguous view 4 bytes into its storage takes the 4-byte path."""
    base = _randn(cuda, 1 + 2 * 7 * 64)
    x = base[1:].view(2, 7, 64)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(transpose.split_heads(x, 4),
                       transpose.plain_split_heads(x, 4))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,tk,kv_len", [(1, 100, 100), (65, 130, 100),
                                          (200, 77, 77), (128, 128, 1),
                                          (1500, 1536, 1500),
                                          (2560, 2560, 2560)])
def test_flash_fwd_matches_plain(cuda, dtype, tol, d, tq, tk, kv_len):
    q = _randn(cuda, 3, tq, d, dtype=dtype, scale=d ** -0.5, seed=1)
    k = _randn(cuda, 3, tk, d, dtype=dtype, seed=2)
    v = _randn(cuda, 3, tk, d, dtype=dtype, seed=3)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, kv_len)
    o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, kv_len)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    _assert_rel(o, o_ref, "o")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,t_max,idx", [(32, 64, 0), (64, 448, 300),
                                         (128, 13000, 12999), (64, 130, 129),
                                         (64, 448, 447), (64, 448, 63),
                                         (64, 64, 1), (16, 8, 0),
                                         (80, 131, 130), (64, 1000, 999)])
def test_decode_self_matches_plain(cuda, dtype, tol, d, t_max, idx):
    """Caches bitwise equal.  idx + 1 below the cluster's size (idx 0, 1),
    slices that do not divide evenly (1000 positions), whisper's own
    T_max 448, rows of an odd T_max (2-byte loads in bf16); 13000
    positions spread over tiles of a cluster of 8."""
    q = _randn(cuda, 2, 3, 1, d, dtype=dtype, scale=d ** -0.5, seed=4)
    kn = _randn(cuda, 2, 3, 1, d, dtype=dtype, seed=5)
    vn = _randn(cuda, 2, 3, 1, d, dtype=dtype, seed=6)
    kb = _randn(cuda, 2, 3, d, t_max, dtype=dtype, seed=7)
    vb = _randn(cuda, 2, 3, d, t_max, dtype=dtype, seed=8)
    kb2, vb2 = kb.clone(), vb.clone()
    out, k_ret, _ = decode.decode_self_attention(q, kn, vn, kb, vb, idx)
    ref, _, _ = decode.plain_decode_self_attention(q, kn, vn, kb2, vb2, idx)
    assert k_ret is kb
    assert torch.equal(kb, kb2) and torch.equal(vb, vb2)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


def _decode_self_inputs(dev, b, h, d, t_max, dtype, offset=0):
    """Inputs of decode_self; the caches are contiguous views ``offset``
    elements into their storage."""
    q = _randn(dev, b, h, 1, d, dtype=dtype, scale=d ** -0.5, seed=4)
    kn = _randn(dev, b, h, 1, d, dtype=dtype, seed=5)
    vn = _randn(dev, b, h, 1, d, dtype=dtype, seed=6)
    n = b * h * d * t_max
    kb = _randn(dev, offset + n, dtype=dtype, seed=7)[offset:].view(b, h, d, t_max)
    vb = _randn(dev, offset + n, dtype=dtype, seed=8)[offset:].view(b, h, d, t_max)
    return q, kn, vn, kb, vb


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,t_max,idx,offset", [
    (65, 8, 448, 447, 0), (4, 20, 448, 200, 0), (16, 8, 128, 127, 0),
    # Caches 1 element into their storage: 2-byte loads in bf16, 4-byte
    # copies in f32.
    (2, 3, 448, 447, 1), (2, 3, 130, 77, 1)])
def test_decode_self_split_is_exact_and_deterministic(cuda, dtype, tol, b, h,
                                                      t_max, idx, offset):
    """One launch per call, caches bitwise equal to the plain version's,
    and two launches on the same inputs give the same bits."""
    q, kn, vn, kb, vb = _decode_self_inputs(cuda, b, h, 64, t_max, dtype,
                                            offset)
    assert offset == 0 or kb.data_ptr() % 16 != 0
    kb2, vb2 = kb.clone(), vb.clone()
    kb3, vb3 = kb.clone(), vb.clone()
    before = kernel_lib.DECODE_SELF.launches
    out, _, _ = decode.decode_self_attention(q, kn, vn, kb, vb, idx)
    assert kernel_lib.DECODE_SELF.launches == before + 1
    again, _, _ = decode.decode_self_attention(q, kn, vn, kb3, vb3, idx)
    ref, _, _ = decode.plain_decode_self_attention(q, kn, vn, kb2, vb2, idx)
    assert torch.equal(kb, kb2) and torch.equal(vb, vb2)
    assert torch.equal(kb3, kb2) and torch.equal(vb3, vb2)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx", [0, 100, 446])
def test_decode_self_never_reads_past_idx(cuda, dtype, idx):
    """NaN in every cache column past idx leaves the output as it is with
    zeros there: those columns are never read."""
    q, kn, vn, kb, vb = _decode_self_inputs(cuda, 16, 8, 64, 448, dtype)
    outs = []
    for fill in (0.0, float("nan")):
        k, v = kb.clone(), vb.clone()
        k[..., idx + 1:] = fill
        v[..., idx + 1:] = fill
        outs.append(decode.decode_self_attention(q, kn, vn, k, v, idx)[0])
    assert torch.isfinite(outs[1].float()).all()
    assert torch.equal(outs[0], outs[1])


def test_decode_self_and_q8_cross_cluster_sizes(cuda):
    """A cluster of 1 to 8 blocks; 1 while the positions fit one block's
    least share, more once there are enough positions a head."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert decode.decode_self_cluster(128, 64, 0, bf16) == 1
    assert decode.decode_self_cluster(128, 64, 31, f32) == 1
    assert decode.decode_self_cluster(128, 64, 127, bf16) > 1
    assert decode.q8_cross_cluster(128, 64, 64) == 1
    for bh in (1, 80, 128, 4096):
        for n in (1, 100, 1500, 15000):
            assert 1 <= decode.q8_cross_cluster(bh, 64, n) <= 8
            assert 1 <= decode.decode_self_cluster(bh, 64, n - 1, bf16) <= 8
    assert decode.q8_cross_cluster(128, 64, 1500) > 1


def _plain_log_mel(wave, n_mels):
    frames = frame_signal(wave, 400, 160)
    return logmel.plain_log_mel(frames, *logmel._device_matrices(
        400, n_mels, 16000, wave.device))


@pytest.mark.parametrize("n_mels,rows", [(80, 37), (128, 2998), (8, 1)])
def test_log_mel_matches_plain(cuda, n_mels, rows):
    wave = _randn(cuda, 160 * (rows - 1) + 400, seed=9)
    before = kernel_lib.LOG_MEL.launches
    got = logmel.log_mel_cuda(wave, n_mels)
    assert kernel_lib.LOG_MEL.launches == before + 1
    assert got.shape == (rows, n_mels)
    torch.testing.assert_close(got, _plain_log_mel(wave, n_mels), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("n_mels", [8, 80, 128])
@pytest.mark.parametrize("batch,frames", [(1, 1), (3, 37), (4, 2998),
                                          (16, 2998), (2, 96), (1, 97)])
def test_log_mel_framed_in_the_kernel(cuda, n_mels, batch, frames):
    """[B, T] waveforms whose frames are not a whole number of the kernel's
    96-frame blocks (1, 37, 97) or are (96), at 1 to 16 x 2998 frames and 8,
    80 and 128 mels, against the plain version at phase 3's atol 1e-3; T
    leaves 100 samples past the last frame, which no frame reads."""
    wave = _randn(cuda, batch, 160 * (frames - 1) + 400 + 100, seed=frames)
    got = logmel.fused_log_mel(wave, n_mels=n_mels)
    assert got.shape == (batch, frames, n_mels)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, _plain_log_mel(wave, n_mels), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("n_fft,hop", [(200, 80), (504, 160), (400, 400),
                                       (16, 8)])
def test_log_mel_other_frames(cuda, n_fft, hop):
    """Other frame lengths and hops: 101 bins (7 warps), 253 bins (16
    warps), frames that do not overlap (the skew for hop 400 is 20), and
    the smallest frame the kernel takes, against the plain version."""
    wave = _randn(cuda, 2, 37 * hop + n_fft, seed=n_fft)
    got = logmel.log_mel_cuda(wave, 40, n_fft, hop)
    frames = frame_signal(wave, n_fft, hop)
    want = logmel.plain_log_mel(frames, *logmel._device_matrices(
        n_fft, 40, 16000, cuda))
    assert got.shape == want.shape == (2, 38, 40)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_log_mel_misaligned_base(cuda, offset):
    """A waveform view 4, 8 or 12 bytes into its storage (not 16-byte
    aligned) takes the kernel's 4-byte copies, rows included."""
    base = _randn(cuda, offset + 3 * 16000, seed=offset)
    wave = base[offset:].view(3, 16000)
    assert wave.data_ptr() % 16 != 0
    torch.testing.assert_close(logmel.log_mel_cuda(wave), _plain_log_mel(
        wave, 80), rtol=0, atol=1e-3)


def test_log_mel_stream_windows_need_no_copy(cuda):
    """stream_log_mel's overlapping windows (rows 30 s apart in one padded
    signal, a strided view) against their .contiguous() frames through the
    same kernel (given frames: hop = n_fft) and the plain version."""
    signal = _randn(cuda, 3 * 480000 + 240, seed=21)
    windows = signal.unfold(0, 480240, 480000)
    assert not windows.is_contiguous()
    assert logmel.kernel_framing(windows, 400, 160).row_stride == 480000
    got = logmel.log_mel_cuda(windows)
    assert got.shape == (3, 3000, 80)
    frames = frame_signal(windows, 400, 160).contiguous()
    given = logmel.log_mel_cuda(frames.reshape(-1), hop_length=400)
    want = _plain_log_mel(windows, 80)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    torch.testing.assert_close(given.view(3, 3000, 80), want, rtol=0,
                               atol=1e-3)
    from tethys_tpu_torch.audio.frontend import stream_log_mel
    audio = signal[:3 * 480000 - 5]
    padded = torch.nn.functional.pad(audio, (0, 245))
    torch.testing.assert_close(
        stream_log_mel(audio),
        _plain_log_mel(padded.unfold(0, 480240, 480000), 80), rtol=0,
        atol=1e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _randn(cuda, 2, 5, 16)
    with pytest.raises(ValueError, match="contiguous"):
        transpose.split_heads(x.transpose(0, 1), 4)
    with pytest.raises(ValueError, match="dtype"):
        transpose.split_heads(x.half(), 4)
    q = _randn(cuda, 2, 8, 16)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention.flash_attention_fwd(q, q, q, 0)
    with pytest.raises(ValueError, match="D=160"):
        big = _randn(cuda, 1, 4, 160)
        flash_attention.flash_attention_fwd(big, big, big)
    q4 = _randn(cuda, 1, 2, 1, 8)
    buf = _randn(cuda, 1, 2, 8, 4)
    with pytest.raises(ValueError, match="index"):
        decode.decode_self_attention(q4, q4, q4, buf, buf.clone(), 4)
    with pytest.raises(TypeError):
        decode.decode_self_attention(q4, q4, q4, buf, buf.clone(),
                                     torch.tensor(1))
    wave = _randn(cuda, 3, 2000)
    with pytest.raises(ValueError, match="bins"):
        logmel.log_mel_cuda(wave, n_fft=512)
    with pytest.raises(ValueError, match="multiples of 8"):
        logmel.log_mel_cuda(wave, hop_length=100)
    with pytest.raises(ValueError, match="float32"):
        logmel.log_mel_cuda(wave.double())


def test_tiny_greedy_identical_on_card_and_cpu(cuda):
    """The encoder (600 frames -> flash kernel), the decode kernel and the
    split kernel in one f32 generate; tokens identical to the CPU run."""
    model, _ = create_whisper_model(device=cuda, seed=1, **TINY)
    cpu_model, _ = create_whisper_model(seed=1, device="cpu", **TINY)
    feats = _randn(torch.device("cpu"), 2, 8, 1200, seed=10)
    kernel_lib.reset_launch_counts()
    tokens, length = greedy_generate(model, feats.to(cuda), max_length=12)
    counts = kernel_lib.launch_counts()
    assert counts["flash_fwd"] == 2 and counts["decode_self"] == 24
    want, want_len = greedy_generate(cpu_model, feats, max_length=12)
    assert torch.equal(tokens.cpu(), want)
    assert int(length) == int(want_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,d", [(37, 3, 16), (1, 8, 64), (5, 4, 6),
                                   (9, 2, 5), (11, 5, 3)])
def test_merge_heads_exact(cuda, dtype, t, h, d):
    """The split's three vector paths, in the merge direction."""
    x = _randn(cuda, 2, h, t, d, dtype=dtype)
    before = kernel_lib.MERGE_HEADS.launches
    got = transpose.merge_heads_cuda(x)
    assert kernel_lib.MERGE_HEADS.launches == before + 1
    assert torch.equal(got, transpose.plain_merge_heads(x))


def test_split_heads_backward_launches_merge(cuda):
    x = _randn(cuda, 2, 7, 64).requires_grad_()
    dy = _randn(cuda, 2, 4, 7, 16, seed=1)
    before = kernel_lib.MERGE_HEADS.launches
    transpose.split_heads(x, 4).backward(dy)
    assert kernel_lib.MERGE_HEADS.launches == before + 1
    assert torch.equal(x.grad, transpose.plain_merge_heads(dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (4096, 0), (1001, 1),
                                      (3 * 1500 * 512, 0)])
def test_dropout_exact(cuda, dtype, n, offset):
    """Bit-exact against the plain Philox, vector and scalar paths."""
    base = _randn(cuda, n + offset, dtype=dtype, seed=11)
    x = base[offset:]
    before = kernel_lib.DROPOUT.launches
    got = dropout.fused_dropout(x, 0.1, 12345)
    assert kernel_lib.DROPOUT.launches == before + 1
    assert torch.equal(got, dropout.plain_dropout(x, 0.1, 12345))


def test_dropout_backward_is_the_same_mask(cuda):
    x = _randn(cuda, 16, 100, 100, dtype=torch.bfloat16).requires_grad_()
    y = dropout.fused_dropout(x, 0.1, 7)
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad != 0, dropout.keep_mask(7, x.shape, 0.1, cuda))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,tk,kv_len", [(1, 100, 100), (65, 130, 100),
                                          (200, 77, 77), (100, 1500, 1500),
                                          (1500, 1536, 1500),
                                          (2560, 2560, 2560)])
def test_flash_fwd_dropout_matches_plain(cuda, dtype, tol, d, tq, tk, kv_len):
    q = _randn(cuda, 3, tq, d, dtype=dtype, scale=d ** -0.5, seed=1)
    k = _randn(cuda, 3, tk, d, dtype=dtype, seed=2)
    v = _randn(cuda, 3, tk, d, dtype=dtype, seed=3)
    before = kernel_lib.FLASH_FWD_DROPOUT.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, kv_len, 0.1, 99)
    assert kernel_lib.FLASH_FWD_DROPOUT.launches == before + 1
    o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, kv_len, 0.1, 99)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    _assert_rel(o, o_ref, "o")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0),
                                             (torch.bfloat16, 3e-2, 1e-2)])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,tk,kv_len", [(1, 100, 100), (65, 130, 100),
                                          (200, 77, 77), (100, 300, 300),
                                          (1500, 1536, 1500),
                                          (2560, 2560, 2560)])
def test_flash_bwd_matches_plain(cuda, rate, dtype, atol, rtol, d, tq, tk,
                                 kv_len):
    """f32: two summation orders.  bf16: the outputs are bf16, and at D 128
    dq reaches ~7, where one bf16 step is 0.03, so a sum that lands on the
    other side of a rounding boundary is one step off: rtol 1e-2 (2-3 bf16
    steps) on top of atol 3e-2."""
    q = _randn(cuda, 3, tq, d, dtype=dtype, scale=d ** -0.5, seed=1)
    k = _randn(cuda, 3, tk, d, dtype=dtype, seed=2)
    v = _randn(cuda, 3, tk, d, dtype=dtype, seed=3)
    do = _randn(cuda, 3, tq, d, dtype=dtype, seed=4)
    o, lse = flash_attention.plain_flash_fwd(q, k, v, kv_len, rate, 5)
    before = kernel_lib.FLASH_BWD.launches
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, kv_len,
                                              rate, 5)
    assert kernel_lib.FLASH_BWD.launches == before + 1
    want = flash_attention.plain_flash_bwd(q, k, v, o, lse, do, kv_len,
                                           rate, 5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=name)
        _assert_rel(a, b, name)
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol_o,atol,rtol", [
    (torch.float32, 1e-5, 1e-4, 0.0), (torch.bfloat16, 2e-2, 3e-2, 1e-2)])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_flash_kernels_misaligned_base(cuda, rate, dtype, tol_o, atol, rtol,
                                       d):
    """Contiguous views one element into their storage, so no base is
    16-byte aligned: the bf16 kernels take their 2-byte loads (and scalar
    dq atomics) inside the same kernel; tolerances as above."""
    tq, tk, kv_len = 130, 200, 190

    def view(shape, seed, scale=1.0):
        n = shape[0] * shape[1] * shape[2]
        base = _randn(cuda, 1 + n, dtype=dtype, scale=scale, seed=seed)
        x = base[1:].view(*shape)
        assert x.data_ptr() % 16 != 0
        return x

    q = view((3, tq, d), 1, d ** -0.5)
    k, v = view((3, tk, d), 2), view((3, tk, d), 3)
    do = view((3, tq, d), 4)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, kv_len, rate, 5)
    o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, kv_len, rate, 5)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol_o)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    _assert_rel(o, o_ref, "o")
    got = flash_attention.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                              kv_len, rate, 5)
    want = flash_attention.plain_flash_bwd(q, k, v, o_ref, lse_ref, do,
                                           kv_len, rate, 5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=name)
        _assert_rel(a, b, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_backward_matches_autograd_of_plain(cuda, rate):
    """f32: the kernel backward against torch autograd through the plain
    forward with the same seed."""
    q, k, v = (_randn(cuda, 4, 130, 64, scale=s, seed=i)
               for i, s in ((1, 0.125), (2, 1.0), (3, 1.0)))
    g = _randn(cuda, 4, 130, 64, seed=4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention.flash_attention(*(t[None] for t in leaves),
                                    dropout_rate=rate, seed=6).backward(g[None])
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref, _ = flash_attention.plain_flash_fwd(*refs, 130, rate, 6)
    o_ref.backward(g)
    for a, b in zip(leaves, refs):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-4)


def test_tiny_training_steps_card_against_cpu(cuda):
    """Three f32 steps with dropout on (the same seeds on both devices, so
    the same masks): every loss to 1e-4 relative; the first step's
    gradients to 1e-3 of each tensor's norm + 1e-6 (k_proj.bias has a
    gradient that is zero but for rounding: softmax does not see a key
    bias), and finite and nonzero on the
    card; parameters to 2 * lr * steps, since Keras Adam's first steps move
    a weight by about lr * sign(g) and a gradient near zero may take either
    sign on two devices.  Every training kernel launched."""
    overrides = dict(TINY, n_ctx=600, vocab_size=128,
                     decoder_start_token_id=101, max_target_positions=128)
    lr, steps = 1e-4, 3
    feats = _randn(torch.device("cpu"), 2, 8, 1200, seed=10)
    labels = torch.randint(3, 100, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    kernel_lib.reset_launch_counts()
    runs = []
    for dev in (cuda, torch.device("cpu")):
        model, _ = create_whisper_model(device=dev, seed=3,
                                        param_dtype=torch.float32, **overrides)
        model.train()
        opt = dp.whisper_optimizer(model.parameters(), lr)
        step = dp.make_train_step(
            lambda m, b, g: (m(b[0], labels=b[1], generator=g)["loss"], {}),
            opt)
        state = dp.TrainState(model, opt)
        losses, grads = [], None
        for i in range(steps):
            state, loss = step(state, (feats.to(dev), labels.to(dev)),
                               dp.step_generator(0, i))
            losses.append(loss.item())
            if grads is None:
                grads = [p.grad.detach().cpu().clone()
                         for p in model.parameters()]
        runs.append((model, losses, grads))
        if dev.type == "cuda":
            counts = kernel_lib.launch_counts()
    (card, card_losses, card_grads), (cpu, cpu_losses, cpu_grads) = runs
    assert all(counts[name] > 0 for name in (
        "split_heads", "merge_heads", "flash_fwd_dropout", "flash_bwd",
        "dropout"))
    torch.testing.assert_close(torch.tensor(card_losses),
                               torch.tensor(cpu_losses), rtol=1e-4, atol=0)
    for (name, _), a, b in zip(cpu.named_parameters(), card_grads, cpu_grads):
        assert torch.isfinite(a).all() and a.norm() > 0, name
        assert (a - b).norm() <= 1e-3 * b.norm() + 1e-6, name
    for a, b in zip(card.parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=2 * lr * steps)


# GroupNorm shapes: wav2vec2-base's widths at small B, ragged T and C (C
# not a multiple of a 16-byte word takes the element-wise form), one row,
# one channel a group, and means far from zero (50, where E[x^2] - mu^2
# would lose digits).
GN_SHAPES = [
    (2, 100, 512, 16, 3.0), (3, 37, 100, 4, 50.0), (1, 1, 16, 16, 0.0),
    (4, 250, 512, 16, -7.0), (2, 6400, 512, 16, 50.0), (5, 17, 130, 2, 1.0),
]


def _gn_inputs(dev, b, t, c, groups, mean, dtype, misaligned=False):
    """x (a view one element into its storage when misaligned, so no
    16-byte path), gamma, beta, dy."""
    n = b * t * c
    flat = (_randn(dev, n + 1, seed=12) + mean).to(dtype)
    x = (flat[1:] if misaligned else flat[:n]).view(b, t, c)
    dy = _randn(dev, n + 1, seed=13).to(dtype)
    dy = (dy[1:] if misaligned else dy[:n]).view(b, t, c)
    return (x, _randn(dev, c, seed=14), _randn(dev, c, seed=15), dy)


def _bf16_ulps(got, want):
    """|got - want| in units of the last place of bf16 at want (8 bits)."""
    _, e = torch.frexp(want.float())
    return ((got.float() - want.float()).abs()
            / torch.ldexp(torch.ones_like(want.float()), e - 8)).max().item()


def _assert_pass(got, want, rel):
    """An elementwise pass against its plain version from the same vectors:
    f32 within rel of the largest magnitude (the operations are rounded in
    the same places, so it reads 0), bf16 within one unit in the last
    place of the plain value rounded once."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1.0
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=rel * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,groups,mean", GN_SHAPES)
def test_gn_stats_matches_plain(cuda, dtype, b, t, c, groups, mean):
    """The moments kernel (one launch) against its plain version.  Both read
    the same dtype-rounded x and sum in f32 in other orders: mean to 1e-5
    of (1 + |mean|), var and rstd to 1e-4 relative."""
    x = _gn_inputs(cuda, b, t, c, groups, mean, dtype)[0]
    before = kernel_lib.GN_STATS.launches
    got = group_norm.group_moments(x, groups)
    assert kernel_lib.GN_STATS.launches == before + 1
    want = group_norm.plain_group_moments(x, groups)
    assert all(g.shape == (b, groups) for g in got)
    torch.testing.assert_close(got[0], want[0], rtol=0,
                               atol=1e-5 * (1 + abs(mean)))
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,groups,mean", GN_SHAPES)
def test_gn_apply_and_backward_match_plain(cuda, dtype, b, t, c, groups,
                                           mean, misaligned):
    """Each pass against its plain version from the same vectors, aligned
    and one element off (the element-wise form): the moments; apply (f32
    1e-5 of max|y|, bf16 one unit in the last place); the grad sums (A, B,
    s1, s2 and dgamma, dbeta to 1e-4 of each largest magnitude: f32 sums
    in other orders); apply_bwd (f32 1e-4 of max|dx|, bf16 one unit)."""
    x, gamma, beta, dy = _gn_inputs(cuda, b, t, c, groups, mean, dtype,
                                    misaligned)
    vec = 16 // x.element_size()
    assert (group_norm.pack_elems(x, dy) == 1) == (misaligned or c % vec != 0)
    mean_g, var_g, rstd_g = group_norm.group_moments(x, groups)
    want = group_norm.plain_group_moments(x, groups)
    torch.testing.assert_close(mean_g, want[0], rtol=0,
                               atol=1e-5 * (1 + abs(mean)))
    _assert_pass(group_norm.apply(x, gamma, beta, mean_g, rstd_g, groups),
                 group_norm.plain_apply(x, gamma, beta, mean_g, rstd_g,
                                        groups), 1e-5)
    sums, s = group_norm.grad_sums(x, dy, mean_g, rstd_g, gamma, groups)
    want_sums, want_s = group_norm.plain_grad_sums(x, dy, mean_g, rstd_g,
                                                   gamma, groups)
    for got_v, want_v in ((sums, want_sums), (s, want_s),
                          (sums.sum(dim=1), want_sums.sum(dim=1))):
        for g, w in zip(got_v, want_v):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-4 * w.abs().max().item())
    _assert_pass(group_norm.apply_bwd(x, dy, gamma, mean_g, rstd_g, s, groups),
                 group_norm.plain_apply_bwd(x, dy, gamma, mean_g, rstd_g, s,
                                            groups), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [6400, 250, 100])
def test_gn_stats_plans_agree_and_repeat(cuda, dtype, t):
    """Every cluster size (1, 2, 4, 8 blocks splitting T, partials met in
    DSMEM in rank order) gives what the plain version gives, within the
    tolerances above; two launches of one plan give the same bits."""
    b, c, groups = 4, 512, 16
    x, gamma, _, dy = _gn_inputs(cuda, b, t, c, groups, 50.0, dtype)
    want = group_norm.plain_group_moments(x, groups)
    for cluster in (1, 2, 4, 8):
        plan = (4, cluster, b * 4)
        got = group_norm.group_moments_cuda(x, groups, plan=plan)
        again = group_norm.group_moments_cuda(x, groups, plan=plan)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5 * 51)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-7)
        sums, s = group_norm.grad_sums_cuda(x, dy, got[0], got[2], gamma,
                                            groups, plan=plan)
        sums2, s2 = group_norm.grad_sums_cuda(x, dy, got[0], got[2], gamma,
                                              groups, plan=plan)
        assert torch.equal(sums, sums2) and torch.equal(s, s2)
        want_sums, want_s = group_norm.plain_grad_sums(x, dy, got[0], got[2],
                                                       gamma, groups)
        for g, w in zip((*sums, *s), (*want_sums, *want_s)):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-4 * w.abs().max().item())


def test_group_norm_on_card_matches_cpu(cuda):
    """The GroupNorm Function on the card (gn_stats, gn_apply; gn_grad_sums,
    gn_apply_bwd: one launch each, no plain GroupNorm) against the CPU,
    f32: y to 1e-5, dx to 1e-4, dgamma and dbeta to 1e-4."""
    gn = norms.ReferenceGroupNorm(64, 16).to(cuda)
    with torch.no_grad():
        gn.gamma.copy_(_randn(cuda, 64, seed=13))
        gn.beta.copy_(_randn(cuda, 64, seed=14))
    x = (_randn(cuda, 3, 90, 64, seed=15) + 5.0).requires_grad_()
    dy = _randn(cuda, 3, 90, 64, seed=16)
    kernel_lib.reset_launch_counts()
    gn(x).backward(dy)
    assert {k: v for k, v in kernel_lib.launch_counts().items() if v} == {
        "gn_stats": 1, "gn_grad_sums": 1, "gn_apply": 1, "gn_apply_bwd": 1}
    cpu = norms.ReferenceGroupNorm(64, 16)
    cpu.load_state_dict({k: v.cpu() for k, v in gn.state_dict().items()})
    xc = x.detach().cpu().requires_grad_()
    yc = cpu(xc)
    yc.backward(dy.cpu())
    torch.testing.assert_close(gn(x).detach().cpu(), yc.detach(), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gn.gamma.grad.cpu(), cpu.gamma.grad,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gn.beta.grad.cpu(), cpu.beta.grad, rtol=1e-4,
                               atol=1e-4)


def test_gn_stats_refuses_what_it_does_not_take(cuda):
    x = _randn(cuda, 2, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm.group_moments(x.transpose(0, 1), 4)
    with pytest.raises(ValueError, match="dtype"):
        group_norm.group_moments(x.half(), 4)
    with pytest.raises(ValueError, match="groups"):
        group_norm.group_moments(x, 5)
    mean, _, rstd = group_norm.group_moments(x, 4)
    ones = torch.ones(32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        group_norm.grad_sums(x, x.bfloat16(), mean, rstd, ones, 4)
    with pytest.raises(ValueError, match="dtype"):
        group_norm.apply(x, ones, ones, mean, rstd, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        group_norm.apply(x, ones.double(), ones, mean, rstd, 4)
    with pytest.raises(ValueError, match="dtype"):
        norms.ReferenceGroupNorm(32, 4, dtype=torch.bfloat16).to(cuda)(x)


def test_tiny_wav2vec2_steps_card_against_cpu(cuda):
    """Three hardened f32 steps of a tiny Wav2Vec2 pretraining model with
    dropout on (the same seeds and negatives on both devices, so the same
    masks): every loss to 1e-4 relative, and the four GroupNorm kernels
    (one launch each per GroupNorm a step) and dropout launched."""
    cfg = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, conv_dim=(32, 32, 32),
               conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               num_codevectors_per_group=24, codevector_dim=32,
               proj_codevector_dim=32, num_negatives=10)
    audio = _randn(torch.device("cpu"), 2, 4000, seed=17)
    kernel_lib.reset_launch_counts()
    runs = []
    for dev in (cuda, torch.device("cpu")):
        model, config = wav2vec2.create_full_model(
            "pretraining", "tiny", device=dev, seed=4, **cfg)
        model.train()
        opt = dp.wav2vec2_optimizer(model.parameters(), 1e-4)

        def loss_fn(m, batch, gen):
            neg = torch.randint(0, 200, (2, 10),
                                generator=torch.Generator().manual_seed(1))
            return wav2vec2.pretraining_loss(config, m(batch, generator=gen),
                                             negative_indices=neg)

        step = dp.make_train_step(loss_fn, opt, hardened=True)
        state = dp.TrainState(model, opt)
        losses = [step(state, audio.to(dev), dp.step_generator(0, i))[1].item()
                  for i in range(3)]
        runs.append(losses)
        if dev.type == "cuda":
            counts = kernel_lib.launch_counts()
    for name in ("gn_stats", "gn_apply", "gn_grad_sums", "gn_apply_bwd"):
        assert counts[name] == 3 * 3, name
    assert counts["dropout"] > 0
    torch.testing.assert_close(torch.tensor(runs[0]), torch.tensor(runs[1]),
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,d,t,kv_len", [
    (2, 3, 64, 1500, None), (1, 4, 16, 1501, 700), (3, 2, 80, 13, 5),
    (1, 2, 128, 15000, 14999), (2, 5, 64, 8, 1),
    (2, 3, 64, 1500, 1), (2, 3, 64, 1500, 7), (2, 3, 64, 1500, 1499),
    (2, 3, 64, 1500, 1000), (4, 20, 64, 1500, None), (65, 8, 64, 1500, 1000),
    (2, 3, 64, 1504, 1501)])
def test_q8_cross_matches_plain(cuda, dtype, tol, b, h, d, t, kv_len):
    """4-byte copies (Tk % 4 == 0), 16-byte copies (Tk 1504) and single
    bytes (Tk 1501, 13); kv_len below the cluster's size (1, 7) and slices
    that do not divide evenly (1499, 1000); whisper-large-v3's B 4 x H 20;
    B 65; Tk 15000 spread over tiles of a cluster of 8.
    The kernel and the plain version read the same int8 caches and scales:
    f32 to 1e-5, bf16 (outputs below 4) to 2e-2."""
    q = _randn(cuda, b, h, 1, d, dtype=dtype, scale=d ** -0.5, seed=20)
    k8, sk = decode.quantize_kv_cols(_randn(cuda, b, h, d, t, seed=21))
    v8, sv = decode.quantize_kv_cols(_randn(cuda, b, h, d, t, seed=22))
    before = kernel_lib.Q8_CROSS.launches
    got = decode.decode_cross_attention_q8(q, k8, sk, v8, sv, kv_len)
    assert kernel_lib.Q8_CROSS.launches == before + 1
    want = decode.plain_q8_cross_attention(q, k8, sk, v8, sv, kv_len)
    assert got.dtype == dtype and got.shape == (b, h, 1, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset,kv_len", [(1, 1500), (4, 1000), (0, 1500)])
def test_q8_cross_split_is_deterministic(cuda, dtype, offset, kv_len):
    """Caches ``offset`` bytes into their storage (1: byte loads, 4: 4-byte
    copies): the plain version's result within the f32 1e-5 / bf16 2e-2
    tolerances, one launch per call, the same bits from two launches."""
    b, h, d, t = 4, 20, 64, 1500
    q = _randn(cuda, b, h, 1, d, dtype=dtype, scale=d ** -0.5, seed=20)
    caches = []
    for seed in (21, 22):
        x8, s = decode.quantize_kv_cols(_randn(cuda, b, h, d, t, seed=seed))
        base = torch.empty(offset + x8.numel(), dtype=torch.int8, device=cuda)
        view = base[offset:].view(b, h, d, t)
        view.copy_(x8)
        caches += [view, s]
    k8, sk, v8, sv = caches
    assert offset == 0 or k8.data_ptr() % 16 != 0
    before = kernel_lib.Q8_CROSS.launches
    got = decode.decode_cross_attention_q8(q, k8, sk, v8, sv, kv_len)
    assert kernel_lib.Q8_CROSS.launches == before + 1
    again = decode.decode_cross_attention_q8(q, k8, sk, v8, sv, kv_len)
    assert torch.equal(got, again)
    want = decode.plain_q8_cross_attention(q, k8, sk, v8, sv, kv_len)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_q8_cross_refuses_what_it_does_not_take(cuda):
    q = _randn(cuda, 1, 2, 1, 8)
    k8, sk = decode.quantize_kv_cols(_randn(cuda, 1, 2, 8, 10))
    with pytest.raises(ValueError, match="kv_len"):
        decode.decode_cross_attention_q8(q, k8, sk, k8, sk, kv_len=11)
    with pytest.raises(ValueError, match="int8"):
        decode.decode_cross_attention_q8(q, k8.float(), sk, k8, sk)
    with pytest.raises(ValueError, match="shapes"):
        decode.decode_cross_attention_q8(_randn(cuda, 1, 2, 2, 8), k8, sk, k8,
                                         sk)


def _route(dtype, route):
    """f32 always takes the exact FFMA kernel; bf16 the route given."""
    return "ffma" if dtype == torch.float32 else route


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6.25e-2)])
@pytest.mark.parametrize("b,t,e_in,e_out,heads,n,route", [
    (2, 1500, 512, 512, 8, 3, "wgmma"), (3, 1, 1280, 1280, 20, 1, "stream"),
    (1, 77, 96, 80, 5, 2, "mma"), (2, 130, 70, 48, 3, 3, "mma"),
    (16, 1, 512, 512, 8, 2, "stream"),
    # M tiles that used to cross a batch boundary mid-way.
    (3, 77, 512, 512, 8, 3, "wgmma"), (3, 130, 512, 512, 8, 3, "wgmma"),
    (3, 1500, 512, 512, 8, 3, "wgmma"),
    # M = 64 and 65, the boundary between the two Hopper routes.
    (4, 16, 512, 512, 8, 3, "stream"), (64, 1, 512, 512, 8, 3, "stream"),
    (5, 13, 512, 512, 8, 2, "wgmma"), (65, 1, 512, 512, 8, 1, "wgmma"),
    # whisper-large-v3's widths.
    (2, 1500, 1280, 1280, 20, 3, "wgmma"), (4, 1, 1280, 1280, 20, 3, "stream")])
def test_proj_split_matches_plain(cuda, dtype, tol, b, t, e_in, e_out, heads,
                                  n, route):
    """Ragged M, N and K tiles, T 1 to 1500, one to three matrices, on the
    route proj_route picks.  f32: sums in other orders; bf16: outputs below
    4 one bf16 step apart where the f32 sums round differently (0.0625
    below 8)."""
    x = _randn(cuda, b, t, e_in, dtype=dtype, seed=23)
    ws = [_randn(cuda, e_out, e_in, scale=e_in ** -0.5, seed=24 + i)
          for i in range(n)]
    bs = [_randn(cuda, e_out, scale=0.1, seed=30 + i) for i in range(n)]
    scales = [0.125] + [1.0] * (n - 1)
    before = kernel_lib.PROJ_SPLIT.launches
    routes = dict(qkv.ROUTE_LAUNCHES)
    got = qkv.project_split_cuda(x, ws, bs, scales, heads)
    assert kernel_lib.PROJ_SPLIT.launches == before + 1
    route = _route(dtype, route)
    assert qkv.ROUTE_LAUNCHES[route] == routes[route] + 1
    want = qkv.plain_project_split_fused(x, ws, bs, scales, heads)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (b, heads, t, e_out // heads)
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6.25e-2)])
@pytest.mark.parametrize("b,heads,t,d,e_out,route", [
    (2, 8, 1500, 64, 512, "wgmma"), (4, 20, 1, 64, 1280, "stream"),
    (1, 3, 77, 10, 50, "mma"), (16, 8, 1, 64, 512, "stream"),
    (3, 8, 77, 64, 512, "wgmma"), (3, 8, 130, 64, 512, "wgmma"),
    (3, 8, 1500, 64, 512, "wgmma"),
    (64, 8, 1, 64, 512, "stream"), (65, 8, 1, 64, 512, "wgmma"),
    (2, 20, 1500, 64, 1280, "wgmma")])
def test_merge_proj_matches_plain(cuda, dtype, tol, b, heads, t, d, e_out,
                                  route):
    attn = _randn(cuda, b, heads, t, d, dtype=dtype, seed=40)
    w = _randn(cuda, e_out, heads * d, scale=(heads * d) ** -0.5, seed=41)
    bias = _randn(cuda, e_out, scale=0.1, seed=42)
    before = kernel_lib.MERGE_PROJ.launches
    routes = dict(qkv.ROUTE_LAUNCHES)
    got = qkv.merge_project_cuda(attn, w, bias)
    assert kernel_lib.MERGE_PROJ.launches == before + 1
    route = _route(dtype, route)
    assert qkv.ROUTE_LAUNCHES[route] == routes[route] + 1
    want = qkv.plain_merge_project_fused(attn, w, bias)
    assert got.dtype == dtype and got.shape == (b, t, e_out)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("t", [1, 300])
def test_proj_kernels_misaligned_views_take_mma(cuda, t):
    """bf16 operands 2 bytes off a 16-byte boundary (views into a larger
    buffer) take the mma.sync kernel, whatever M, and match the plain
    versions."""
    def view(n, *shape, seed):
        flat = _randn(cuda, n + 1, dtype=torch.bfloat16, seed=seed)
        return flat[1:].view(*shape)

    x = view(2 * t * 512, 2, t, 512, seed=70)
    w = _randn(cuda, 512, 512, dtype=torch.bfloat16, scale=512 ** -0.5,
               seed=71)
    bias = view(512, 512, seed=72)
    assert x.data_ptr() % 16 and bias.data_ptr() % 16
    routes = dict(qkv.ROUTE_LAUNCHES)
    got = qkv.project_split_cuda(x, [w], [bias], [0.125], 8)
    want = qkv.plain_project_split_fused(x, [w], [bias], [0.125], 8)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=6.25e-2)
    attn = view(2 * 8 * t * 64, 2, 8, t, 64, seed=73)
    got = qkv.merge_project_cuda(attn, w, bias)
    want = qkv.plain_merge_project_fused(attn, w, bias)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=6.25e-2)
    assert qkv.ROUTE_LAUNCHES["mma"] == routes["mma"] + 2
    assert qkv.ROUTE_LAUNCHES["wgmma"] == routes["wgmma"]
    assert qkv.ROUTE_LAUNCHES["stream"] == routes["stream"]


def test_fused_projections_on_card_have_a_grad_fn(cuda, monkeypatch):
    """With TETHYS_FUSED_QKV=1 a CUDA projection launches the kernels and
    records a grad_fn; its gradients equal autograd through the plain
    versions (f32, 1e-4 of each gradient's largest magnitude); a shape the
    kernel cannot take raises."""
    monkeypatch.setenv("TETHYS_FUSED_QKV", "1")
    x = _randn(cuda, 2, 30, 64, seed=50).requires_grad_()
    w = [_randn(cuda, 64, 64, scale=0.125, seed=51 + i).requires_grad_()
         for i in range(3)]
    bias = [_randn(cuda, 64, scale=0.1, seed=55 + i).requires_grad_()
            for i in range(3)]
    before = (kernel_lib.PROJ_SPLIT.launches, kernel_lib.MERGE_PROJ.launches)
    outs = qkv.project_split(x, list(zip(w, bias, (0.125, 1.0, 1.0))), 4)
    y = qkv.merge_project(outs[0] + outs[1] + outs[2], w[0], bias[0])
    assert (kernel_lib.PROJ_SPLIT.launches, kernel_lib.MERGE_PROJ.launches) \
        == (before[0] + 1, before[1] + 1)
    assert y.grad_fn is not None
    y.square().sum().backward()
    leaves = [t.detach().clone().requires_grad_() for t in (x, *w, *bias)]
    ref = qkv.plain_project_split_fused(leaves[0], leaves[1:4], leaves[4:],
                                        (0.125, 1.0, 1.0), 4)
    qkv.plain_merge_project_fused(ref[0] + ref[1] + ref[2], leaves[1],
                                  leaves[4]).square().sum().backward()
    for got, want in zip((x, *w, *bias), leaves):
        err = (got.grad - want.grad).abs().max() / want.grad.abs().max()
        assert err <= 1e-4
    with pytest.raises(ValueError, match="not divisible"):
        qkv.project_split(x, [(w[0][:60], bias[0][:60], 1.0)], 8)

    # bf16 compute on f32 master weights at a shape of the wgmma route (M
    # 300, two 64-wide heads): linear losses, so the gradients do not
    # depend on the forward's rounding; bf16 against autograd through the
    # plain versions, within BF16_REL_LIMIT of each largest magnitude.
    xb = _randn(cuda, 2, 150, 128, dtype=torch.bfloat16, seed=60)
    wb = [_randn(cuda, 128, 128, scale=128 ** -0.5, seed=61 + i)
          for i in range(3)]
    bb = [_randn(cuda, 128, scale=0.1, seed=65 + i) for i in range(3)]
    cots = [_randn(cuda, 2, 2, 150, 64, dtype=torch.bfloat16, seed=68 + i)
            for i in range(3)]
    attn = _randn(cuda, 2, 2, 150, 64, dtype=torch.bfloat16, seed=72)
    dy = _randn(cuda, 2, 150, 128, dtype=torch.bfloat16, seed=73)

    def grads(fused):
        leaves = [t.clone().requires_grad_() for t in (xb, *wb, *bb, attn)]
        scales = (0.125, 1.0, 1.0)
        if fused:
            outs = qkv.project_split(
                leaves[0], list(zip(leaves[1:4], leaves[4:7], scales)), 2)
            y = qkv.merge_project(leaves[7], leaves[1], leaves[4])
            assert y.grad_fn is not None and outs[0].grad_fn is not None
        else:
            outs = qkv.plain_project_split_fused(leaves[0], leaves[1:4],
                                                 leaves[4:7], scales, 2)
            y = qkv.plain_merge_project_fused(leaves[7], leaves[1], leaves[4])
        loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cots))
        (loss + (y.float() * dy.float()).sum()).backward()
        return [t.grad for t in leaves]

    before = qkv.ROUTE_LAUNCHES["wgmma"]
    fused = grads(True)
    assert qkv.ROUTE_LAUNCHES["wgmma"] == before + 2
    for i, (got, want) in enumerate(zip(fused, grads(False))):
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= BF16_REL_LIMIT, f"gradient {i}: relative error {rel}"


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_int8_long_audio_card_against_cpu(cuda, monkeypatch, fused):
    """f32 int8 long-audio serving on a tiny model, with and without the
    fused projections: per-window tokens identical on card and CPU, and the
    int8 kernel launched at every decode step of every layer."""
    from tethys_tpu_torch.inference import transcribe_long_audio

    if fused:
        monkeypatch.setenv("TETHYS_FUSED_QKV", "1")
    overrides = dict(TINY, n_mels=80, n_ctx=100, kv_quant="int8")
    wave = _randn(torch.device("cpu"), int(4.5 * 16000), seed=60).numpy()
    model, _ = create_whisper_model(device=cuda, seed=5, **overrides)
    kernel_lib.reset_launch_counts()
    ids_card = transcribe_long_audio(model, wave, max_length=8)
    counts = kernel_lib.launch_counts()
    cpu_model, _ = create_whisper_model(device="cpu", seed=5, **overrides)
    ids_cpu = transcribe_long_audio(cpu_model, wave, max_length=8)
    assert len(ids_card) == len(ids_cpu) == 3
    for a, b in zip(ids_card, ids_cpu):
        assert (a == b).all()
    assert counts["q8_cross"] == 8 * TINY["decoder_layers"]
    assert counts["log_mel"] == 1
    if fused:
        assert counts["proj_split"] > 0 and counts["merge_proj"] > 0
        assert counts["split_heads"] == 0
    else:
        assert counts["proj_split"] == counts["merge_proj"] == 0
