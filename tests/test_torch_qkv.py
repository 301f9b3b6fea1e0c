"""The port's fused projections (``TETHYS_FUSED_QKV=1``) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

The same numpy-seeded x, weights and biases go through
``pallas_qkv.project_split`` / ``merge_project`` (interpret mode, fused
path on, as tests/test_pallas_qkv.py runs them) and the port's
``project_split`` / ``merge_project``, whose CPU tensors take the plain
versions of the kernels' numerics inside the autograd Functions.  JAX
kernels are [E_in, E_out], the port's weights torch's [E_out, E_in].
Tolerances: f32 forward 1e-5 (two f32 sums in other orders); bf16 forward
2e-2 (outputs below 2, where one bf16 step is 0.0078, may round apart
where the f32 sums differ); f32 gradients 1e-4 relative (sums over up to
B * T rows in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.ops import pallas_qkv as pq
from tethys_tpu_torch.ops import qkv

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    monkeypatch.setattr(pq, "_INTERPRET", True)
    monkeypatch.setenv("TETHYS_FUSED_QKV", "1")


def _inputs(seed, b, t, e, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    kernels = [(rng.standard_normal((e, e)) * 0.05).astype(np.float32)
               for _ in range(n)]
    biases = [(rng.standard_normal(e) * 0.1).astype(np.float32)
              for _ in range(n)]
    scales = [0.125] + [1.0] * (n - 1)
    return x, kernels, biases, scales


def _jax_proj(x, kernels, biases, scales, dtype):
    return [(jnp.asarray(k), jnp.asarray(b), s)
            for k, b, s in zip(kernels, biases, scales)], jnp.asarray(x, dtype)


def _port_proj(x, kernels, biases, scales, dtype):
    return [(torch.from_numpy(k.T.copy()), torch.from_numpy(b), s)
            for k, b, s in zip(kernels, biases, scales)], \
        torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("t,heads", [(256, 8), (96, 4)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_project_split_matches_pallas(n, t, heads, dtype, tol):
    x, kernels, biases, scales = _inputs(0, 2, t, 128, n)
    jprojs, jx = _jax_proj(x, kernels, biases, scales, getattr(jnp, dtype))
    want = pq.project_split(jx, jprojs, heads)
    tprojs, tx = _port_proj(x, kernels, biases, scales, getattr(torch, dtype))
    got = qkv.project_split(tx, tprojs, heads)
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert g.shape == (2, heads, t, 128 // heads)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("t,heads", [(256, 8), (96, 4)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_merge_project_matches_pallas(t, heads, dtype, tol):
    rng = np.random.default_rng(3)
    attn = rng.standard_normal((2, heads, t, 32)).astype(np.float32)
    kernel = (rng.standard_normal((heads * 32, 128)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.1).astype(np.float32)
    want = pq.merge_project(jnp.asarray(attn, getattr(jnp, dtype)),
                            jnp.asarray(kernel), jnp.asarray(bias))
    got = qkv.merge_project(torch.from_numpy(attn).to(getattr(torch, dtype)),
                            torch.from_numpy(kernel.T.copy()),
                            torch.from_numpy(bias))
    assert got.shape == (2, t, 128) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _assert_rel(got, want, tol=1e-4):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("t,heads,n", [(64, 4, 3), (96, 8, 1)])
def test_project_split_grads_match_jax_vjp(t, heads, n):
    """Gradients through ProjectSplit against jax.grad through the custom
    VJP, for x, every weight and every bias; each cotangent weighted by its
    output's position so that no two are alike."""
    x, kernels, biases, scales = _inputs(1, 2, t, 64, n)

    def jloss(x, ks, bs):
        outs = pq.project_split(x, list(zip(ks, bs, scales)), heads)
        return sum(jnp.sum(o * (i + 1.0) * o) for i, o in enumerate(outs))

    gx, gk, gb = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), tuple(map(jnp.asarray, kernels)),
        tuple(map(jnp.asarray, biases)))
    tx = torch.from_numpy(x).requires_grad_()
    tw = [torch.from_numpy(k.T.copy()).requires_grad_() for k in kernels]
    tb = [torch.from_numpy(b).requires_grad_() for b in biases]
    outs = qkv.project_split(tx, list(zip(tw, tb, scales)), heads)
    assert all(o.grad_fn is not None for o in outs)
    sum(((i + 1.0) * o * o).sum() for i, o in enumerate(outs)).backward()
    _assert_rel(tx.grad, gx)
    for w, b, jk, jb in zip(tw, tb, gk, gb):
        _assert_rel(w.grad, np.asarray(jk).T)
        _assert_rel(b.grad, jb)


def test_merge_project_grads_match_jax_vjp():
    rng = np.random.default_rng(4)
    attn = rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
    kernel = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(96) * 0.1).astype(np.float32)
    want = jax.grad(lambda a, k, b: jnp.sum(pq.merge_project(a, k, b) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(attn), jnp.asarray(kernel),
                                       jnp.asarray(bias))
    ta = torch.from_numpy(attn).requires_grad_()
    tw = torch.from_numpy(kernel.T.copy()).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y = qkv.merge_project(ta, tw, tb)
    assert y.grad_fn is not None
    (y ** 2).sum().backward()
    _assert_rel(ta.grad, want[0])
    _assert_rel(tw.grad, np.asarray(want[1]).T)
    _assert_rel(tb.grad, want[2])


def test_fused_gradients_take_the_parameter_dtype():
    """bf16 compute on f32 master weights: dW and db come back f32 (summed
    in f32, as the JAX VJP casts to the parameter's dtype), dx in bf16."""
    x, kernels, biases, scales = _inputs(2, 1, 32, 64, 3)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = [torch.from_numpy(k.T.copy()).requires_grad_() for k in kernels]
    tb = [torch.from_numpy(b).requires_grad_() for b in biases]
    outs = qkv.project_split(tx, list(zip(tw, tb, scales)), 4)
    merged = qkv.merge_project(outs[0], tw[0], tb[0])
    merged.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in tw + tb)


def test_fused_path_is_read_at_call_time(monkeypatch):
    """Unset, the default F.linear + split_heads path runs (no autograd
    Function of the fused path); both paths agree in f32."""
    x, kernels, biases, scales = _inputs(5, 2, 16, 32, 3)
    tprojs, tx = _port_proj(x, kernels, biases, scales, torch.float32)
    tprojs = [(w.requires_grad_(), b, s) for w, b, s in tprojs]
    fused = qkv.project_split(tx, tprojs, 4)
    assert type(fused[0].grad_fn).__name__ == "ProjectSplitBackward"
    monkeypatch.delenv("TETHYS_FUSED_QKV")
    plain = qkv.project_split(tx, tprojs, 4)
    assert type(plain[0].grad_fn).__name__ != "ProjectSplitBackward"
    for a, b in zip(fused, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fused_path_refuses_shapes_it_cannot_take():
    x = torch.zeros(1, 4, 12)
    w, b = torch.zeros(10, 12), torch.zeros(10)
    with pytest.raises(ValueError, match="not divisible"):
        qkv.project_split(x, [(w, b, 1.0)], 4)
    with pytest.raises(ValueError, match="1-3"):
        qkv.project_split(x, [(torch.zeros(12, 12), torch.zeros(12), 1.0)] * 4,
                          4)
    meta = torch.empty(1, 4, 12, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        qkv.project_split(meta, [(torch.zeros(12, 12, device="meta"),
                                  torch.zeros(12, device="meta"), 1.0)], 4)


@pytest.mark.parametrize("m,n,k,head_dim,dtype,aligned,route", [
    # whisper-base b16's encoder and large-v3's 4 windows (20 heads).
    (16 * 1500, 512, 512, 64, torch.bfloat16, True, "wgmma"),
    (4 * 1500, 1280, 1280, 64, torch.bfloat16, True, "wgmma"),
    # Their decode steps, [16, 1, 512] and [4, 1, 1280].
    (16, 512, 512, 64, torch.bfloat16, True, "stream"),
    (4, 1280, 1280, 64, torch.bfloat16, True, "stream"),
    # The boundary between the two Hopper routes.
    (64, 512, 512, 64, torch.bfloat16, True, "stream"),
    (65, 512, 512, 64, torch.bfloat16, True, "wgmma"),
    # The ragged shapes of tests/test_torch_cuda.py and misaligned views.
    (77, 80, 96, 16, torch.bfloat16, True, "mma"),
    (2 * 130, 48, 70, 16, torch.bfloat16, True, "mma"),
    (77, 50, 30, 10, torch.bfloat16, True, "mma"),
    (16 * 1500, 512, 512, 64, torch.bfloat16, False, "mma"),
    (16, 512, 512, 64, torch.bfloat16, False, "mma"),
    # f32 always takes the exact FFMA kernel.
    (16 * 1500, 512, 512, 64, torch.float32, True, "ffma"),
    (16, 512, 512, 64, torch.float32, True, "ffma"),
    (77, 80, 96, 16, torch.float32, False, "ffma"),
])
def test_proj_route_by_shape(m, n, k, head_dim, dtype, aligned, route):
    assert qkv.proj_route(m, n, k, head_dim, dtype, aligned) == route
    assert route in qkv.ROUTES and route in qkv.ROUTE_LAUNCHES


def test_cpu_tensors_launch_no_route():
    """CPU tensors take the plain versions: no route counts a launch."""
    before = dict(qkv.ROUTE_LAUNCHES)
    x, kernels, biases, scales = _inputs(6, 2, 8, 128, 3)
    tprojs, tx = _port_proj(x, kernels, biases, scales, torch.bfloat16)
    outs = qkv.project_split(tx, tprojs, 2)
    qkv.merge_project(outs[0], tprojs[0][0], tprojs[0][1])
    assert qkv.ROUTE_LAUNCHES == before
