"""The port's kernel modules against the JAX package, on the CPU.

Each kernel's plain version (what a CPU tensor runs) is held to the JAX
function that reaches the Pallas kernel, run in interpret mode as the JAX
package's own tests run it.  Inputs come from numpy seeds; f32 throughout.
Dropout bits cannot match the TPU's (another generator), so dropout is
held to JAX at rate 0 and otherwise to its own contract: Philox's
known-answer vectors, the kept fraction, one mask in forward and backward.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tethys_tpu.ops.pallas_attention as pa
from tethys_tpu.ops import pallas_decode as pd
from tethys_tpu.ops import pallas_gn
from tethys_tpu.ops import pallas_transpose as ptr
from tethys_tpu.ops.activations import gelu as jax_gelu
from tethys_tpu.ops.attention import decode_attention as jax_decode_attention
from tethys_tpu.ops.masks import causal_additive_mask as jax_causal
from tethys_tpu.ops.posenc import sinusoidal_table as jax_sinusoidal
from tethys_tpu_torch.ops import (
    attention,
    decode,
    dropout,
    flash_attention,
    group_norm,
    transpose,
)
from tethys_tpu_torch.ops.activations import gelu
from tethys_tpu_torch.ops.masks import causal_additive_mask
from tethys_tpu_torch.ops.posenc import sinusoidal_table
from tethys_tpu_torch.utils import device, kernel_lib

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parents[1] / "tethys_tpu_torch"


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("b,t,h,d", [(2, 37, 4, 16), (3, 1, 8, 64)])
def test_split_heads_matches_pallas(monkeypatch, b, t, h, d):
    monkeypatch.setattr(ptr, "_INTERPRET", True)
    x = np.random.default_rng(0).standard_normal((b, t, h * d)).astype(
        np.float32)
    want = np.asarray(ptr.split_heads(jnp.asarray(x), h))
    got = transpose.split_heads(_t(x), h)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)  # a pure permute
    np.testing.assert_array_equal(transpose.merge_heads(got).numpy(), x)


@pytest.mark.parametrize("b,t,h,d", [(16, 1, 8, 64), (2, 37, 1, 16)],
                         ids=["T=1", "H=1"])
def test_split_heads_decode_step_is_a_view(monkeypatch, b, t, h, d):
    """Where [B, T, H*d] and [B, H, T, d] hold the same bytes in the same
    order (a decode step's T = 1, or H = 1), split_heads is a view of x: it
    shares x's storage, equals JAX's split_heads in interpret mode, and
    launches nothing."""
    monkeypatch.setattr(ptr, "_INTERPRET", True)
    x = np.random.default_rng(1).standard_normal((b, t, h * d)).astype(
        np.float32)
    want = np.asarray(ptr.split_heads(jnp.asarray(x), h))
    xt = _t(x)
    kernel_lib.reset_launch_counts()
    got = transpose.split_heads(xt, h)
    assert transpose.split_is_a_view(xt, h)
    assert got.untyped_storage().data_ptr() == xt.untyped_storage().data_ptr()
    assert got.shape == (b, h, t, d) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(n == 0 for n in kernel_lib.launch_counts().values())
    xg = xt.clone().requires_grad_()
    y = transpose.split_heads(xg, h)
    y.backward(torch.ones_like(y))
    assert torch.equal(xg.grad, torch.ones_like(xt))


def _qkv(rng, bh, t, d):
    q = rng.standard_normal((1, bh, t, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((1, bh, t, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((1, bh, t, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("t,kv_len", [(128, 128), (200, 200), (200, 150)])
def test_plain_flash_matches_pallas(monkeypatch, t, kv_len):
    """o and lse of the plain flash forward against the Pallas forward
    (_fwd4 pads rows to its blocks and slices back), tolerance 2e-5 as in
    tests/test_pallas_attention.py."""
    monkeypatch.setattr(pa, "_INTERPRET", True)
    q, k, v = _qkv(np.random.default_rng(1), 2, t, 64)
    want_o, want_lse = pa._fwd4(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.zeros((1,), jnp.int32), dropout_rate=0.0,
                                kv_len=kv_len)
    o, lse = flash_attention.flash_attention_fwd(_t(q[0]), _t(k[0]), _t(v[0]),
                                                 kv_len)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o)[0],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[0, :, 0],
                               rtol=2e-5, atol=2e-5)
    full = flash_attention.flash_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    np.testing.assert_allclose(
        full.numpy(),
        np.asarray(pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), kv_len=kv_len)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("side", ["port", "pallas"])
@pytest.mark.parametrize("t,kv_len", [(128, 128), (200, 200), (200, 150)])
def test_flash_sides_match_float64(monkeypatch, side, t, kv_len):
    """Each side of test_plain_flash_matches_pallas alone against a float64
    softmax(q k^T) v on test_plain_flash_matches_pallas's inputs: o and lse
    within 2e-6 (each reads about 3e-7 from it), so a drift past that
    test's 2e-5 names the side it came from."""
    monkeypatch.setattr(pa, "_INTERPRET", True)
    q, k, v = _qkv(np.random.default_rng(1), 2, t, 64)
    if side == "port":
        o, lse = (x.numpy() for x in flash_attention.flash_attention_fwd(
            _t(q[0]), _t(k[0]), _t(v[0]), kv_len))
    else:
        o, lse = pa._fwd4(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.zeros((1,), jnp.int32), dropout_rate=0.0,
                          kv_len=kv_len)
        o, lse = np.asarray(o)[0], np.asarray(lse)[0, :, 0]
    s64 = np.einsum("bqd,bkd->bqk", q[0].astype(np.float64),
                    k[0].astype(np.float64))
    s64[..., kv_len:] = -np.inf
    m = s64.max(-1, keepdims=True)
    p = np.exp(s64 - m)
    np.testing.assert_allclose(o, p @ v[0].astype(np.float64)
                               / p.sum(-1, keepdims=True), rtol=0, atol=2e-6)
    np.testing.assert_allclose(lse, (m + np.log(p.sum(-1, keepdims=True)))[
        ..., 0], rtol=0, atol=2e-6)


def test_flash_dropout_not_ported():
    """Dropout in flash attention is ported (this test once pinned the
    refusal of a nonzero rate).  At rate 0.1 it drops the probabilities
    of its own (seed, flat [BH, Tq, Tk] index) mask after the row sum: the output
    equals the composition written out, a seed gives one output, and rate
    0 is the undropped forward."""
    rng = np.random.default_rng(11)
    q = _t(rng.standard_normal((1, 2, 24, 16)).astype(np.float32) * 0.3)
    k = _t(rng.standard_normal((1, 2, 40, 16)).astype(np.float32) * 0.3)
    v = _t(rng.standard_normal((1, 2, 40, 16)).astype(np.float32))
    got = flash_attention.flash_attention(q, k, v, dropout_rate=0.1, seed=7)
    s = torch.matmul(q[0], k[0].transpose(1, 2))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    keep = dropout.keep_mask(7, (2, 24, 40), 0.1)
    want = (torch.matmul(torch.where(keep, p, 0.0), v[0])
            * (dropout.dropout_scale(0.1) / p.sum(-1, keepdim=True)))
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    again = flash_attention.flash_attention(q, k, v, dropout_rate=0.1, seed=7)
    assert torch.equal(got, again)
    other = flash_attention.flash_attention(q, k, v, dropout_rate=0.1, seed=8)
    assert not torch.equal(got, other)
    undropped = flash_attention.flash_attention(q, k, v, dropout_rate=0.0,
                                                seed=7)
    assert torch.equal(undropped, flash_attention.flash_attention(q, k, v))
    # the backward regenerates that mask: FlashAttention's gradients equal
    # autograd through the plain forward with the same seed.
    qs, ks, vs = (x[0].clone().requires_grad_() for x in (q, k, v))
    g = _t(rng.standard_normal((2, 24, 16)).astype(np.float32))
    flash_attention.FlashAttention.apply(qs, ks, vs, 40, 0.1, 7).backward(g)
    qr, kr, vr = (x[0].clone().requires_grad_() for x in (q, k, v))
    o_ref, _ = flash_attention.plain_flash_fwd(qr, kr, vr, 40, 0.1, 7)
    o_ref.backward(g)
    for a, b in ((qs, qr), (ks, kr), (vs, vr)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("tq,tk,kv_len", [(200, 200, 200), (100, 640, 640),
                                          (100, 640, 600), (128, 2560, 2560),
                                          (128, 2560, 2500)])
def test_plain_flash_bwd_matches_pallas(monkeypatch, tq, tk, kv_len):
    """dq, dk, dv of the plain backward (and of the FlashAttention Function
    on CPU tensors) against jax.grad of the Pallas flash attention in
    interpret mode at rate 0: self (1, 2, 200, 64), cross 100 x 640, and
    128 x 2560, where the keys span two 1280-key blocks and JAX takes its
    several-block pair _bwd_dq_kernel and _bwd_dkv_kernel in place of the
    fused _bwd_dkv_dq_kernel; with and without masked keys; rtol 1e-4,
    atol 1e-5 as tests/test_pallas_attention.py."""
    monkeypatch.setattr(pa, "_INTERPRET", True)
    traced = {}
    for name in ("_bwd_dkv_dq_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel"):
        def counting(*refs, _kernel=getattr(pa, name), _name=name, **kw):
            traced[_name] = traced.get(_name, 0) + 1
            return _kernel(*refs, **kw)
        monkeypatch.setattr(pa, name, counting)
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 2, tq, 64)).astype(np.float32) * 0.3
    k = rng.standard_normal((1, 2, tk, 64)).astype(np.float32) * 0.3
    v = rng.standard_normal((1, 2, tk, 64)).astype(np.float32)
    g = rng.standard_normal((1, 2, tq, 64)).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(pa.flash_attention(q, k, v, kv_len=kv_len)
                                * jnp.asarray(g)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    q3, k3, v3, g3 = (_t(x[0]) for x in (q, k, v, g))
    o, lse = flash_attention.flash_attention_fwd(q3, k3, v3, kv_len)
    plain = flash_attention.flash_attention_bwd(q3, k3, v3, o, lse, g3,
                                                kv_len)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    flash_attention.flash_attention(*leaves, kv_len=kv_len).backward(_t(g))
    for w, p, leaf in zip(want, plain, leaves):
        np.testing.assert_allclose(p.numpy(), np.asarray(w)[0], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    several = pa._block_sizes(tq, tk)[1] < tk
    assert several == (tk > pa.MAX_BLOCK_K)
    # (the fused kernel's body calls _bwd_dkv_kernel too)
    if several:
        assert pa._block_sizes(tq, tk) == (128, 1280)
        assert set(traced) == {"_bwd_dq_kernel", "_bwd_dkv_kernel"}
    else:
        assert set(traced) == {"_bwd_dkv_dq_kernel", "_bwd_dkv_kernel"}


@pytest.mark.parametrize("b,t,c,groups,mean", [
    (3, 96, 32, 4, 50.0),      # the JAX test's shape; a far-off mean
    (2, 100, 24, 3, 7.0),      # T with no multiple-of-8 divisor
    (1, 250, 16, 16, 0.0),     # one channel a group, a 5 s clip's T
])
def test_group_moments_match_pallas(monkeypatch, b, t, c, groups, mean):
    """The plain moments against pallas_gn.group_moments in interpret mode
    (mean 1e-6, var 1e-4 relative); where the Pallas kernel takes no
    shape (its stats_chunk finds no divisor and it returns None) against
    two-pass jnp moments, as tests/test_ops.py's reference."""
    monkeypatch.setattr(pallas_gn, "_INTERPRET", True)
    x = (mean + np.random.default_rng(5).standard_normal((b, t, c))).astype(
        np.float32)
    got_mean, got_var, got_rstd = group_norm.group_moments(_t(x), groups)
    want = pallas_gn.group_moments(jnp.asarray(x), groups)
    if want is None:
        assert pallas_gn.stats_chunk(t) == 0
        xg = jnp.asarray(x).reshape(b, t, groups, c // groups)
        mean_g = xg.mean(axis=(1, 3))
        want = (mean_g, jnp.square(xg - mean_g[:, None, :, None]).mean(
            axis=(1, 3)))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=0)
    assert got_mean.dtype == got_var.dtype == got_rstd.dtype == torch.float32
    np.testing.assert_allclose(got_rstd.numpy(),
                               1 / np.sqrt(np.asarray(want[1]) + 1e-5),
                               rtol=1e-4, atol=0)
    bf = group_norm.group_moments(_t(x).bfloat16(), groups)
    ref = group_norm.plain_group_moments(_t(x).bfloat16().float(), groups)
    assert all(torch.equal(a, r) for a, r in zip(bf, ref))


def test_group_moments_chunking_fills_the_card():
    """The moments kernel's launch (stats_plan) at wav2vec2-base b32 (T
    6400 ... 100 and a 5 s clip's 250, bf16): at most one wave of 4 blocks
    on each of 132 SMs, every item resident at once and a block on every
    SM where the items allow; a cluster splits T only where an item has
    rows to spare."""
    for t in (6400, 3200, 1600, 800, 400, 200, 100, 250, 1):
        n_ctile, cluster, n_clusters = group_norm.stats_plan(
            32, t, 512, 16, 8, 2, 4, 132)
        grid = cluster * n_clusters
        assert grid <= 4 * 132 and 16 % n_ctile == 0 and cluster <= t
        assert n_clusters == 32 * n_ctile and grid >= min(132, 32 * n_ctile)


def test_split_heads_gradient_is_a_merge():
    x = _t(np.random.default_rng(13).standard_normal((2, 5, 12)).astype(
        np.float32)).requires_grad_()
    y = transpose.split_heads(x, 3)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    y.backward(dy)
    assert torch.equal(x.grad, transpose.plain_merge_heads(dy))
    assert torch.equal(x.grad, transpose.merge_heads(dy))


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_plain_philox_known_answers(counter, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    words = dropout.philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in words) == want


def test_dropout_bits_are_a_function_of_seed_and_index():
    bits = dropout.philox_bits(5, 103)
    assert torch.equal(bits, dropout.philox_bits(5, 103))
    assert torch.equal(bits[:50], dropout.philox_bits(5, 50))
    assert not torch.equal(bits, dropout.philox_bits(6, 103))
    # elements 100-102 are outputs 0-2 of Philox at counter 25, key (5, 0)
    zero = torch.zeros(1, dtype=torch.int64)
    words = dropout.philox4x32_10((zero + 25, zero, zero, zero), (5, 0))
    assert [int(w) for w in words[:3]] == bits[100:].tolist()
    assert dropout.dropout_threshold(0.1) == int(0.1 * 2 ** 32)
    assert dropout.dropout_threshold(1.0) == 2 ** 32 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_identity_at_rate_zero(dtype):
    x = torch.randn(4, 9, generator=torch.Generator().manual_seed(1)).to(dtype)
    assert dropout.fused_dropout(x, 0.0, 3) is x
    assert dropout.module_dropout(x, 0.1, False, None) is x
    assert dropout.module_dropout(x, 0.0, True, None) is x


def test_dropout_kept_fraction_and_scale():
    """At rate 0.1 over 1e5 elements the kept fraction lies within 5
    binomial standard deviations of 0.9, and survivors are x / 0.9."""
    n, rate = 100_000, 0.1
    x = torch.full((n // 100, 100), 2.0)
    y = dropout.fused_dropout(x, rate, 1234)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0],
                                                  2.0 * dropout.dropout_scale(rate)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_same_mask_forward_and_backward(dtype):
    """grad of sum(dropout(x)) is exactly mask / (1 - r), the forward's
    mask."""
    x = torch.randn(3, 7, 5, generator=torch.Generator().manual_seed(2)).to(
        dtype).requires_grad_()
    y = dropout.fused_dropout(x, 0.25, 99)
    y.sum().backward()
    keep = dropout.keep_mask(99, x.shape, 0.25)
    scale = torch.tensor(dropout.dropout_scale(0.25)).to(dtype)
    assert torch.equal(x.grad, torch.where(keep, scale, 0.0).to(dtype))
    assert torch.equal(y != 0, keep & (x != 0))


def test_dropout_seeds_come_from_a_cpu_generator():
    gen = torch.Generator().manual_seed(0)
    seeds = [dropout.seed_from_generator(gen) for _ in range(3)]
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds) and len(set(seeds)) == 3
    assert dropout.seed_from_generator(
        torch.Generator().manual_seed(0)) == seeds[0]
    with pytest.raises(ValueError, match="Generator"):
        dropout.module_dropout(torch.ones(3), 0.1, True, None)
    with pytest.raises(ValueError, match="generator"):
        attention.multi_head_attention(*(torch.ones(1, 1, 2, 4),) * 3,
                                       dropout_rate=0.1, training=True)


def _decode_inputs(rng, b, h, d, t, idx):
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32) * d ** -0.5
    k_new = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    v_new = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    filled = np.arange(t)[None, None, None, :] < idx
    k_buf = np.where(filled, rng.standard_normal((b, h, d, t)), 0).astype(
        np.float32)
    v_buf = np.where(filled, rng.standard_normal((b, h, d, t)), 0).astype(
        np.float32)
    return q, k_new, v_new, k_buf, v_buf


@pytest.mark.parametrize("b,h,d,t,idx", [
    (2, 8, 64, 128, 0), (2, 8, 64, 128, 57), (2, 8, 64, 128, 127),
    (1, 4, 32, 64, 5), (2, 8, 64, 448, 447),
])
def test_plain_decode_self_matches_pallas(monkeypatch, b, h, d, t, idx):
    """Caches exact (the append is a pure write), output to 1e-6."""
    monkeypatch.setattr(pd, "_INTERPRET", True)
    args = _decode_inputs(np.random.default_rng(2), b, h, d, t, idx)
    want_out, want_k, want_v = pd._fused_call(
        *map(jnp.asarray, args), jnp.asarray(idx, jnp.int32))
    tensors = [_t(a).clone() for a in args]
    out, k_buf, v_buf = decode.decode_self_attention(*tensors, idx)
    assert k_buf is tensors[3] and v_buf is tensors[4]  # appended in place
    np.testing.assert_array_equal(k_buf.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(v_buf.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-6, atol=1e-6)


def test_decode_cross_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32) * 0.25
    k_t = rng.standard_normal((2, 4, 16, 50)).astype(np.float32)
    v_t = rng.standard_normal((2, 4, 16, 50)).astype(np.float32)
    for kv_len in (None, 31):
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k_t),
                                    jnp.asarray(v_t), kv_len=kv_len)
        got = attention.decode_attention(_t(q), _t(k_t), _t(v_t),
                                         kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_small_ops_match_jax():
    x = np.random.default_rng(4).standard_normal((3, 7)).astype(np.float32) * 3
    np.testing.assert_allclose(gelu(_t(x)).numpy(),
                               np.asarray(jax_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert gelu(_t(x).bfloat16()).dtype == torch.bfloat16
    np.testing.assert_array_equal(sinusoidal_table(30, 16),
                                  jax_sinusoidal(30, 16))
    # Same allowed set; both masks give probability 0 above the diagonal.
    port_mask = causal_additive_mask(6).numpy()
    jax_mask = np.asarray(jax_causal(6))
    np.testing.assert_array_equal(port_mask == 0, jax_mask == 0)
    assert (port_mask[jax_mask != 0] <= -1e9).all()


def test_flash_gate_is_cuda_only():
    assert attention.flash_active(True, 1500, 1500, is_cuda=True)
    assert not attention.flash_active(True, 1500, 1500, is_cuda=False)
    assert not attention.flash_active(True, 1, 1500, is_cuda=True)
    assert not attention.flash_active(False, 1500, 1500, is_cuda=True)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version for CPU tensors only."""
    meta = torch.empty(1, 3, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        transpose.split_heads(meta, 2)
    q = torch.empty(1, 2, 1, 4, device="meta")
    buf = torch.empty(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        decode.decode_self_attention(q, q, q, buf, buf, 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        dropout.fused_dropout(meta, 0.1, 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        transpose.split_heads(meta.requires_grad_(), 2)
    q3 = torch.empty(2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention.flash_attention_bwd(q3, q3, q3, q3,
                                            torch.empty(2, 8, device="meta"),
                                            q3)


def test_cpu_tensors_leave_launch_counts_at_zero():
    kernel_lib.reset_launch_counts()
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    transpose.split_heads(x, 2)
    q3 = torch.randn(2, 20, 8, generator=torch.Generator().manual_seed(1))
    flash_attention.flash_attention_fwd(q3, q3, q3)
    q = torch.zeros(1, 2, 1, 4)
    decode.decode_self_attention(q, q, q, torch.zeros(1, 2, 4, 3),
                                 torch.zeros(1, 2, 4, 3), 1)
    xg = x.clone().requires_grad_()
    transpose.split_heads(xg, 2).sum().backward()
    q3g = q3.clone().requires_grad_()
    flash_attention.flash_attention(q3g[None], q3g[None], q3g[None],
                                    dropout_rate=0.1, seed=1).sum().backward()
    dropout.fused_dropout(x, 0.1, 1)
    k8, sk = decode.quantize_kv_cols(torch.randn(1, 2, 4, 3))
    decode.decode_cross_attention_q8(q, k8, sk, k8, sk)
    assert all(n == 0 for n in kernel_lib.launch_counts().values())
    assert [k.name for k in kernel_lib.KERNELS] == [
        "log_mel", "split_heads", "merge_heads", "flash_fwd",
        "flash_fwd_dropout", "flash_bwd", "dropout", "decode_self",
        "gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd", "q8_cross",
        "proj_split", "merge_proj"]
    for k in kernel_lib.KERNELS:
        assert (PKG.parent / k.source).is_file()
        assert (PKG.parent / k.replaces.split(":")[0]).is_file()


def test_require_cuda_never_falls_back():
    if torch.cuda.is_available():
        assert device.require_cuda() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.require_cuda()


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    """Nothing under tethys_tpu_torch/ imports jax, flax or tethys_tpu,
    nor does chip_smoke.py."""
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 10
    assert PKG / "scripts" / "bench_flash.py" in files
    for path in files:
        bad = set(_imported_roots(path)) & {"jax", "jaxlib", "flax",
                                            "tethys_tpu"}
        assert not bad, f"{path.relative_to(PKG.parent)} imports {sorted(bad)}"
