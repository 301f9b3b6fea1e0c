"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips
where torch.cuda.is_available() is false (as on a CPU-only machine).
These cover the kernels' branches off the main path's shapes: head
dims 16-128, ragged sequence edges, misaligned and odd-width head splits,
caches that need more than 48 KB of shared memory, and the wrappers'
refusals.  On a machine with the card and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which the card's machine
need not have; nothing here uses JAX.)
"""

import pytest
import torch

from tethys_tpu_torch.audio import logmel
from tethys_tpu_torch.audio.frontend import frame_signal
from tethys_tpu_torch.models.whisper import create_whisper_model, greedy_generate
from tethys_tpu_torch.ops import decode, flash_attention, transpose
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,d", [(37, 3, 16), (1, 8, 64), (5, 4, 6),
                                   (9, 2, 5), (11, 5, 3)])
def test_split_heads_exact(cuda, dtype, t, h, d):
    """16-byte vectors (d*size % 16 == 0), 4-byte words, 2-byte elements."""
    x = _randn(cuda, 2, t, h * d, dtype=dtype)
    before = kernel_lib.SPLIT_HEADS.launches
    got = transpose.split_heads(x, h)
    assert kernel_lib.SPLIT_HEADS.launches == before + 1
    assert torch.equal(got, transpose.plain_split_heads(x, h))


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
                                          (200, 77, 77), (128, 128, 1)])
def test_flash_fwd_matches_plain(cuda, dtype, tol, d, tq, tk, kv_len):
    q = _randn(cuda, 3, tq, d, dtype=dtype, scale=d ** -0.5, seed=1)
    k = _randn(cuda, 3, tk, d, dtype=dtype, seed=2)
    v = _randn(cuda, 3, tk, d, dtype=dtype, seed=3)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, kv_len)
    o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, kv_len)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,t_max,idx", [(32, 64, 0), (64, 448, 300),
                                         (128, 13000, 12999), (64, 130, 129)])
def test_decode_self_matches_plain(cuda, dtype, tol, d, t_max, idx):
    """Caches bitwise equal; 13000 positions need 52 KB of shared memory."""
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


@pytest.mark.parametrize("n_mels,rows", [(80, 37), (128, 2998), (8, 1)])
def test_log_mel_matches_plain(cuda, n_mels, rows):
    wave = _randn(cuda, 160 * (rows - 1) + 400, seed=9)
    frames = frame_signal(wave, 400, 160).contiguous()
    assert frames.shape == (rows, 400)
    mats = logmel._device_matrices(400, n_mels, 16000, cuda)
    got = logmel.log_mel_cuda(frames, *mats)
    torch.testing.assert_close(got, logmel.plain_log_mel(frames, *mats),
                               rtol=0, atol=1e-3)


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
    frames = _randn(cuda, 3, 512)
    mats = logmel._device_matrices(512, 80, 16000, cuda)
    with pytest.raises(ValueError, match="bins"):
        logmel.log_mel_cuda(frames, *mats)


def test_tiny_greedy_identical_on_card_and_cpu(cuda):
    """The encoder (600 frames -> flash kernel), the decode kernel and the
    split kernel in one f32 generate; tokens identical to the CPU run."""
    model, _ = create_whisper_model(device=cuda, seed=1, **TINY)
    cpu_model, _ = create_whisper_model(seed=1, **TINY)
    feats = _randn(torch.device("cpu"), 2, 8, 1200, seed=10)
    kernel_lib.reset_launch_counts()
    tokens, length = greedy_generate(model, feats.to(cuda), max_length=12)
    counts = kernel_lib.launch_counts()
    assert counts["flash_fwd"] == 2 and counts["decode_self"] == 24
    want, want_len = greedy_generate(cpu_model, feats, max_length=12)
    assert torch.equal(tokens.cpu(), want)
    assert int(length) == int(want_len)
