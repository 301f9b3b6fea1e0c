"""The port's GroupNorm (ops/group_norm.py, ops/norms.py) against the JAX
package on the CPU, and its launch shapes.

The plain versions of the four entry points (moments, grad sums, apply,
apply_bwd: what a CPU tensor runs, and what the card's kernels are held to)
are compared with JAX's ``_gn_core`` (tethys_tpu/ops/norms.py), its forward
and its closed-form VJP through ``jax.vjp``, in f32 from numpy seeds:
outputs to rtol 1e-5, gradients to rtol 1e-4 (f32 sums in other orders),
at a ragged T, a mean far from zero, one channel a group.  The launch-shape
pickers are pure Python: every row of every wav2vec2-base shape is covered
exactly once, within one wave, by clusters of at most 8 blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.ops.norms import ReferenceGroupNorm as JaxGroupNorm
from tethys_tpu.ops.norms import _gn_core
from tethys_tpu_torch.ops import group_norm, norms
from tethys_tpu_torch.profiling import step_profile
from tethys_tpu_torch.utils import kernel_lib

torch.set_num_threads(2)

EPS = 1e-5
# wav2vec2-base's GroupNorm inputs: T after each conv of a 2 s clip, and
# the last conv of a 5 s clip.
W2V_T = (6400, 3200, 1600, 800, 400, 200, 100, 250)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(b, t, c, mean, seed=21):
    rng = np.random.default_rng(seed)
    x = (mean + rng.standard_normal((b, t, c))).astype(np.float32)
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal((b, t, c)).astype(np.float32)
    return x, gamma, beta, dy


@pytest.mark.parametrize("b,t,c,groups,mean", [
    (2, 37, 32, 4, 3.0),       # ragged T
    (2, 250, 64, 16, 50.0),    # a 5 s clip's T, a mean far from zero
    (1, 101, 24, 3, -7.0),     # C not a multiple of a 16-byte word
    (3, 16, 16, 16, 0.5),      # one channel a group
])
def test_plain_passes_match_gn_core(b, t, c, groups, mean):
    """Each plain entry point against _gn_core and float64: the moments
    (mean 1e-6 of (1 + |mean|), var 1e-4 relative), apply against the JAX
    forward (1e-5, plus what the means' difference moves), the grad sums'
    s1 and s2 against float64 group means of dy gamma and dy gamma xhat
    (1e-4 of their largest magnitude), and apply_bwd and the summed A, B
    against jax.vjp's dx, dgamma, dbeta (rtol 1e-4, atol 1e-5)."""
    x, gamma, beta, dy = _inputs(b, t, c, mean)
    core = _gn_core(groups, EPS)
    y, vjp = jax.vjp(core, *map(jnp.asarray, (x, gamma, beta)))
    dx, dg, db = vjp(jnp.asarray(dy))
    xt, gt, bt, dyt = map(_t, (x, gamma, beta, dy))

    mean_g, var_g, rstd_g = group_norm.group_moments(xt, groups)
    xg = x.astype(np.float64).reshape(b, t, groups, c // groups)
    m64 = xg.mean(axis=(1, 3))
    v64 = np.square(xg - m64[:, None, :, None]).mean(axis=(1, 3))
    np.testing.assert_allclose(mean_g.numpy(), m64, rtol=0,
                               atol=1e-6 * (1 + abs(mean)))
    np.testing.assert_allclose(var_g.numpy(), v64, rtol=1e-4)
    np.testing.assert_allclose(rstd_g.numpy(), 1 / np.sqrt(v64 + EPS),
                               rtol=1e-4)

    got_y = group_norm.apply(xt, gt, bt, mean_g, rstd_g, groups)
    assert got_y.dtype == torch.float32
    # The two sides' means may differ by 1e-6 of (1 + |mean|) (f32 sums in
    # other orders), which moves y by gamma * rstd times that.
    shift = 1e-6 * (1 + abs(mean)) * np.abs(gamma).max() * rstd_g.max().item()
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5 + shift)

    sums, s = group_norm.grad_sums(xt, dyt, mean_g, rstd_g, gt, groups)
    assert sums.shape == (2, b, c) and s.shape == (2, b, groups)
    xhat = ((xg - m64[:, None, :, None])
            / np.sqrt(v64 + EPS)[:, None, :, None]).reshape(b, t, c)
    dyg = dy.astype(np.float64) * gamma
    n = t * (c // groups)
    s1 = dyg.sum(axis=1).reshape(b, groups, -1).sum(-1) / n
    s2 = (dyg * xhat).sum(axis=1).reshape(b, groups, -1).sum(-1) / n
    for got_s, want_s in ((s[0], s1), (s[1], s2)):
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                                   atol=1e-4 * np.abs(want_s).max())

    got_dx = group_norm.apply_bwd(xt, dyt, gt, mean_g, rstd_g, s, groups)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=1e-5)
    dgamma, dbeta = sums.sum(dim=1)
    np.testing.assert_allclose(dgamma.numpy(), np.asarray(dg), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dbeta.numpy(), np.asarray(db), rtol=1e-4,
                               atol=1e-5)


def _bf16_ulps(got, want):
    """|got - want| in units of the last place of bf16 at want (8 bits)."""
    _, e = torch.frexp(want.float())
    return ((got.float() - want.float()).abs()
            / torch.ldexp(torch.ones_like(want.float()), e - 8)).max().item()


@pytest.mark.parametrize("x_dtype,module_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_function_returns_the_module_dtype(x_dtype, module_dtype):
    """The Function writes the module's dtype itself (its output's grad_fn
    is the Function's backward, no cast after it): the JAX module's output
    at that dtype, within one bf16 unit in the last place (f32: rtol 1e-5);
    dx in x's dtype against jax.vjp (f32 rtol 1e-4; bf16 one unit)."""
    x, gamma, beta, dy = _inputs(2, 45, 64, 5.0, seed=22)
    jx = jnp.asarray(x).astype(jnp.dtype(str(x_dtype).split(".")[1]))
    jgn = JaxGroupNorm(groups=16, dtype=jnp.dtype(
        str(module_dtype).split(".")[1]))
    y, vjp = jax.vjp(lambda x, g, b: jgn.apply(
        {"params": {"gamma": g, "beta": b}}, x), jx, jnp.asarray(gamma),
        jnp.asarray(beta))
    (dx, _, _) = vjp(jnp.asarray(dy).astype(y.dtype))
    gn = norms.ReferenceGroupNorm(64, 16, dtype=module_dtype)
    with torch.no_grad():
        gn.gamma.copy_(_t(gamma))
        gn.beta.copy_(_t(beta))
    xt = _t(np.asarray(jx.astype(jnp.float32))).to(x_dtype).requires_grad_()
    out = gn(xt)
    assert out.dtype == module_dtype
    assert "GroupNormFunction" in type(out.grad_fn).__name__
    out.backward(_t(np.asarray(jnp.asarray(dy).astype(y.dtype).astype(
        jnp.float32))).to(module_dtype))
    assert xt.grad.dtype == x_dtype
    want_y = _t(np.asarray(y.astype(jnp.float32))).to(module_dtype)
    want_dx = _t(np.asarray(dx.astype(jnp.float32))).to(x_dtype)
    if module_dtype == torch.bfloat16:
        assert _bf16_ulps(out.detach(), want_y) <= 1.0
    else:
        np.testing.assert_allclose(out.detach().numpy(), want_y.numpy(),
                                   rtol=1e-5, atol=1e-5)
    if x_dtype == torch.bfloat16:
        assert _bf16_ulps(xt.grad, want_dx) <= 1.0
    else:
        np.testing.assert_allclose(xt.grad.numpy(), want_dx.numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("blocks_per_sm,sm_count", [
    (4, 132), (3, 132), (8, 132), (2, 114), (1, 16)])
@pytest.mark.parametrize("vec,elem", [(8, 2), (4, 4), (1, 2), (1, 4)],
                         ids=["bf16", "f32", "bf16-scalar", "f32-scalar"])
def test_stats_plan_covers_every_row_once(vec, elem, blocks_per_sm,
                                          sm_count):
    """stats_plan at wav2vec2-base's widths (C 512, 16 groups) for every T
    (b 32 and b 2): channel tiles of whole groups that fit a block's
    threads, clusters of at most 8 blocks, a grid within one wave of the
    given occupancy, and, walking the clusters over their items as the
    kernel does (item = cluster id, + n_clusters, ...; rank r takes rows
    [T r / S, T (r + 1) / S)), every row of every channel tile exactly
    once."""
    for b in (32, 2):
        for t in W2V_T:
            n_ctile, cluster, n_clusters = group_norm.stats_plan(
                b, t, 512, 16, vec, elem, blocks_per_sm, sm_count)
            ctile = 512 // n_ctile
            assert 16 % n_ctile == 0 and ctile % 32 == 0
            assert ctile % vec == 0 and ctile // vec <= 256
            assert 1 <= cluster <= 8 and cluster <= t
            assert cluster * n_clusters <= blocks_per_sm * sm_count
            cover = np.zeros((b * n_ctile, t), dtype=np.int32)
            for cid in range(n_clusters):
                for item in range(cid, b * n_ctile, n_clusters):
                    for rank in range(cluster):
                        cover[item, t * rank // cluster:
                              t * (rank + 1) // cluster] += 1
            assert (cover == 1).all(), (b, t)


def test_stats_plan_choices():
    """At the occupancy the H100 reports (2 blocks an SM, 132 SMs; 132,
    62 and 30 clusters of 2, 4 and 8 at once), the plan sweep's fastest:
    wav2vec2-base b32 fills the wave with its items and no cluster, 256
    items of 64 bf16 channels at T = 6400 and, where the rows are few and
    a block's item end weighs more, 128 of 128 at T = 100; at b2 (the f32
    gate's batch) the items are few and a cluster of 4 splits T; a cluster
    never exceeds what fits.  No tile of whole groups that fits a block's
    threads: ValueError."""
    fit = {2: 132, 4: 62, 8: 30}
    for t in W2V_T:
        n_ctile, cluster, n_clusters = group_norm.stats_plan(
            32, t, 512, 16, 8, 2, 2, 132, fit)
        assert cluster == 1 and n_clusters == 32 * n_ctile
    assert group_norm.stats_plan(32, 6400, 512, 16, 8, 2, 2, 132, fit) == (
        8, 1, 256)
    assert group_norm.stats_plan(32, 100, 512, 16, 8, 2, 2, 132, fit) == (
        4, 1, 128)
    assert group_norm.stats_plan(2, 6400, 512, 16, 4, 4, 2, 132, fit) == (
        16, 4, 32)
    n_ctile, cluster, n_clusters = group_norm.stats_plan(
        2, 6400, 512, 16, 4, 4, 2, 132, fit, inputs=2)
    assert cluster > 1 and n_clusters <= fit[cluster]
    with pytest.raises(ValueError, match="no channel tile"):
        group_norm.stats_plan(2, 10, 512, 1, 1, 2, 4, 132)


@pytest.mark.parametrize("t", W2V_T)
def test_apply_grid_is_at_most_one_wave(t):
    """gn_apply.cu's grid: one block per row group of 256 threads (4 rows
    of 64 threads at C 512 bf16, 8 in f32), at most one wave."""
    for vec, slots in ((8, 4), (4, 2), (1, 1)):
        for blocks_per_sm, sm_count in ((8, 132), (3, 132), (1, 16)):
            grid = group_norm.apply_grid(32 * t, 512, vec, blocks_per_sm,
                                         sm_count)
            assert grid == min(-(-32 * t // slots),
                               blocks_per_sm * sm_count)


def test_step_profile_files_the_groupnorm_kernels():
    """The profiler files each GroupNorm kernel under its own name and the
    torch work left inside the Function under GroupNorm."""
    for kernel, category in (
            ("gn_moments_kernel<__nv_bfloat16, 8>", "gn_stats kernel (moments)"),
            ("gn_grad_sums_kernel<__nv_bfloat16, 8>", "gn_grad_sums kernel"),
            ("gn_apply_kernel<float, 4>", "gn_apply kernel"),
            ("gn_apply_bwd_kernel<float, 1>", "gn_apply_bwd kernel")):
        name = f"void (anonymous namespace)::{kernel}((anonymous namespace)::Params)"
        assert step_profile.categorise(name, ["GroupNormFunction"]) == category
    assert step_profile.categorise(
        "reduce_kernel", ["aten::sum", "GroupNormFunctionBackward"]
    ) == "GroupNorm (torch around its kernels)"


def test_group_norm_takes_plain_versions_on_the_cpu_only():
    """CPU tensors run the plain versions and launch nothing; other devices
    raise (no kernel, no plain version)."""
    kernel_lib.reset_launch_counts()
    x, gamma, beta, dy = map(_t, _inputs(2, 9, 32, 1.0, seed=23))
    gn = norms.ReferenceGroupNorm(32, 4)
    xg = x.clone().requires_grad_()
    gn(xg).backward(dy)
    assert all(n == 0 for n in kernel_lib.launch_counts().values())
    meta = torch.empty(2, 9, 32, device="meta")
    vec = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        group_norm.group_moments(meta, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        group_norm.apply(meta, gamma, beta, vec, vec, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        group_norm.grad_sums(meta, meta, vec, vec, gamma, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        group_norm.apply_bwd(meta, meta, gamma, vec, vec,
                             torch.empty(2, 2, 4, device="meta"), 4)
