"""The port's kernel modules against the JAX package, on the CPU.

Each kernel's plain version (what a CPU tensor runs) is held to the JAX
function that reaches the Pallas kernel, run in interpret mode as the JAX
package's own tests run it.  Inputs come from numpy seeds; f32 throughout.
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
from tethys_tpu.ops import pallas_transpose as ptr
from tethys_tpu.ops.activations import gelu as jax_gelu
from tethys_tpu.ops.attention import decode_attention as jax_decode_attention
from tethys_tpu.ops.masks import causal_additive_mask as jax_causal
from tethys_tpu.ops.posenc import sinusoidal_table as jax_sinusoidal
from tethys_tpu_torch.ops import attention, decode, flash_attention, transpose
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


def test_flash_dropout_not_ported():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention.flash_attention(q, q, q, dropout_rate=0.1)


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
    (1, 4, 32, 64, 5),
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


def test_cpu_tensors_leave_launch_counts_at_zero():
    kernel_lib.reset_launch_counts()
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    transpose.split_heads(x, 2)
    q3 = torch.randn(2, 20, 8, generator=torch.Generator().manual_seed(1))
    flash_attention.flash_attention_fwd(q3, q3, q3)
    q = torch.zeros(1, 2, 1, 4)
    decode.decode_self_attention(q, q, q, torch.zeros(1, 2, 4, 3),
                                 torch.zeros(1, 2, 4, 3), 1)
    assert all(n == 0 for n in kernel_lib.launch_counts().values())
    assert [k.name for k in kernel_lib.KERNELS] == [
        "log_mel", "split_heads", "flash_fwd", "decode_self"]
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
    for path in files:
        bad = set(_imported_roots(path)) & {"jax", "jaxlib", "flax",
                                            "tethys_tpu"}
        assert not bad, f"{path.relative_to(PKG.parent)} imports {sorted(bad)}"
