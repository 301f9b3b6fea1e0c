"""The port's SpecAugment masks, positional encodings and JCTTimer against
the JAX package, on the CPU.

A torch.Generator takes the place of JAX's key, so the random run starts
cannot match: the masks are held to JAX's bit for bit from JAX's own starts
(the draw JAX's _run_mask makes with that key), and the generator's draws
to their contract (one state, one mask; the masked share of
1 - (1 - p)^run_length).  The encodings are held to flax's apply bit for bit.
"""

import inspect
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.ops import masks as jax_masks
from tethys_tpu.ops import posenc as jax_posenc
from tethys_tpu.utils.artifacts import JCTTimer as JaxJCTTimer
from tethys_tpu_torch.convert import flax_from_state_dict, params_from_flax
from tethys_tpu_torch.ops import masks, posenc
from tethys_tpu_torch.utils.artifacts import JCTTimer

torch.set_num_threads(2)

# (B, L, prob, run_length): runs longer than L, runs of one, no starts.
MASK_CASES = [(2, 40, 0.2, 5), (3, 17, 0.3, 1), (2, 6, 0.5, 10),
              (2, 30, 0.0, 10), (4, 64, 0.05, 10), (1, 25, 1.0, 3)]


def _nonzero(rng, shape):
    """Seeded values none of which is 0, so a zero marks the mask."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.where(x >= 0, x + 0.5, x - 0.5).astype(np.float32)


def _jax_starts(key, b, length, prob):
    return np.array(jax.random.bernoulli(key, prob, (b, length)))


@pytest.mark.parametrize("b,length,prob,run", MASK_CASES)
def test_run_mask_from_starts_matches_jax(b, length, prob, run):
    """From the starts JAX's _run_mask draws with a key, the port's
    expansion equals JAX's mask bit for bit."""
    key = jax.random.PRNGKey(length + run)
    starts = _jax_starts(key, b, length, prob)
    want = np.asarray(jax_masks._run_mask(key, b, length, prob, run))
    got = masks.run_mask_from_starts(torch.from_numpy(starts), run)
    assert got.dtype == torch.bool and got.shape == (b, length)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", ["time", "feature"])
@pytest.mark.parametrize("b,length,prob,run", MASK_CASES)
def test_masked_outputs_match_jax(monkeypatch, axis, b, length, prob, run):
    """apply_time_mask / apply_feature_mask from JAX's starts: the zero
    pattern of JAX's output is the port's run_mask_from_starts, and the
    port's masked output equals JAX's bit for bit."""
    key = jax.random.PRNGKey(7 * length + run)
    other = 5
    shape = (b, length, other) if axis == "time" else (b, other, length)
    x = _nonzero(np.random.default_rng(length), shape)
    starts = _jax_starts(key, b, length, prob)
    jax_fn = (jax_masks.apply_time_mask if axis == "time"
              else jax_masks.apply_feature_mask)
    want = np.asarray(jax_fn(key, jnp.asarray(x), mask_prob=prob,
                             mask_length=run))
    mask = masks.run_mask_from_starts(torch.from_numpy(starts), run)
    zeros = (want == 0).all(axis=2 if axis == "time" else 1)
    np.testing.assert_array_equal(mask.numpy(), zeros)
    assert (want == 0).sum() == mask.sum().item() * other

    seen = []

    def from_jax_starts(generator, batch, n, p, run_length, device=None):
        seen.append((generator, batch, n, p, run_length, device))
        return masks.run_mask_from_starts(
            torch.from_numpy(starts).to(device), run_length)

    monkeypatch.setattr(masks, "_run_mask", from_jax_starts)
    port_fn = (masks.apply_time_mask if axis == "time"
               else masks.apply_feature_mask)
    got = port_fn(None, torch.from_numpy(x), mask_prob=prob, mask_length=run)
    assert seen == [(None, b, length, prob, run, torch.device("cpu"))]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_defaults_match_jax():
    """JAX's defaults: the time mask 0.05 and 10, the feature mask 0.0 (it
    leaves its input as it is) and 10."""
    for name in ("apply_time_mask", "apply_feature_mask"):
        port = inspect.signature(getattr(masks, name)).parameters
        ref = inspect.signature(getattr(jax_masks, name)).parameters
        for arg in ("mask_prob", "mask_length"):
            assert port[arg].default == ref[arg].default, (name, arg)
    x = torch.from_numpy(_nonzero(np.random.default_rng(3), (2, 30, 8)))
    assert torch.equal(masks.apply_feature_mask(torch.Generator(), x), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generator_draws_repeat_and_keep_dtype(dtype):
    """One generator state gives one mask; another seed another; the
    output keeps the input's dtype and device; the time mask zeroes whole
    time steps, the feature mask whole channels."""
    x = torch.from_numpy(_nonzero(np.random.default_rng(4),
                                  (3, 50, 12))).to(dtype)
    for fn, prob, whole in ((masks.apply_time_mask, 0.2, 2),
                            (masks.apply_feature_mask, 0.3, 1)):
        a = fn(torch.Generator().manual_seed(11), x, mask_prob=prob,
               mask_length=3)
        b = fn(torch.Generator().manual_seed(11), x, mask_prob=prob,
               mask_length=3)
        c = fn(torch.Generator().manual_seed(12), x, mask_prob=prob,
               mask_length=3)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert a.dtype == dtype and a.device == x.device
        zero = a == 0
        whole_zero = zero.all(dim=whole, keepdim=True)
        assert whole_zero.any()
        assert torch.equal(zero, whole_zero.expand_as(zero))
        assert torch.equal(a[~zero], x[~zero])


def _masked_share_sigma(prob, run, batch, interior):
    """Standard deviation of the masked share of ``interior`` positions
    per row over ``batch`` independent rows: neighbours closer than
    ``run`` share starts, so the covariance at distance d < run is
    a (1 - p)^d - a^2, a = (1 - p)^run."""
    a = (1 - prob) ** run
    var = interior * a * (1 - a)
    for d in range(1, run):
        var += 2 * (interior - d) * (a * (1 - prob) ** d - a * a)
    return np.sqrt(batch * var) / (batch * interior)


@pytest.mark.parametrize("axis", ["time", "feature"])
@pytest.mark.parametrize("prob,run", [(0.05, 10), (0.2, 3)])
def test_masked_share_statistics(axis, prob, run):
    """Over a large draw the masked share of interior positions (those a
    whole window of starts can reach) lies within 4 sigma of
    1 - (1 - p)^run_length."""
    batch, length = 64, 2000
    x = torch.ones(batch, length, 1) if axis == "time" else \
        torch.ones(batch, 1, length)
    fn = masks.apply_time_mask if axis == "time" else masks.apply_feature_mask
    out = fn(torch.Generator().manual_seed(2024), x, mask_prob=prob,
             mask_length=run).reshape(batch, length)
    share = (out[:, run - 1:] == 0).double().mean().item()
    want = 1 - (1 - prob) ** run
    sigma = _masked_share_sigma(prob, run, batch, length - run + 1)
    assert abs(share - want) < 4 * sigma, (share, want, sigma)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("d_model,t", [(16, 37), (6, 12)])
def test_sinusoidal_positional_encoding_matches_flax(dtype, jdtype, d_model,
                                                     t):
    """SinusoidalPositionalEncoding equals flax's apply bit for bit in f32
    and bf16; its table is a constant: no params in flax, nothing in the
    port's state dict."""
    x = np.random.default_rng(d_model).standard_normal(
        (2, t, d_model)).astype(np.float32)
    ref = jax_posenc.SinusoidalPositionalEncoding(d_model=d_model, max_len=64,
                                                  dtype=jdtype)
    jx = jnp.asarray(x).astype(jdtype)
    variables = ref.init(jax.random.PRNGKey(0), jx)
    assert not jax.tree_util.tree_leaves(variables)
    want = np.asarray(ref.apply(variables, jx).astype(jnp.float32))
    mod = posenc.SinusoidalPositionalEncoding(d_model, max_len=64,
                                              dtype=dtype)
    assert mod.state_dict() == {} and not list(mod.parameters())
    got = mod(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.shape == (2, t, d_model)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("d_model", [8, 9, 1])
def test_relative_position_table_matches_jax(d_model):
    """relative_position_table equals JAX's bit for bit at even and odd
    d_model."""
    np.testing.assert_array_equal(
        posenc.relative_position_table(50, d_model),
        jax_posenc.relative_position_table(50, d_model))


@pytest.mark.parametrize("dim,length", [(12, 20), (7, 33)])
def test_relative_positional_encoding_carries_flax_weights(dim, length):
    """RelativePositionalEncoding starts as flax's init; with flax weights
    carried through params_from_flax into load_state_dict it equals
    flax's apply bit for bit, the state dict maps back to the same flax
    tree, and pos_embedding gets the gradient jax.grad gives."""
    max_length = 40
    ref = jax_posenc.RelativePositionalEncoding(dim=dim, max_length=max_length)
    init = ref.init(jax.random.PRNGKey(0), length)["params"]
    mod = posenc.RelativePositionalEncoding(dim, max_length=max_length)
    np.testing.assert_array_equal(mod.pos_embedding.detach().numpy(),
                                  np.asarray(init["pos_embedding"]))

    rng = np.random.default_rng(dim)
    table = (np.asarray(init["pos_embedding"])
             + 0.1 * rng.standard_normal((max_length, dim))).astype(np.float32)
    params = {"pos_embedding": jnp.asarray(table)}
    state = params_from_flax(params)
    assert list(state) == ["pos_embedding"]
    mod.load_state_dict(state)
    want = np.asarray(ref.apply({"params": params}, length))
    got = mod(length)
    assert got.shape == (length, dim)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    back = flax_from_state_dict(mod.state_dict())
    np.testing.assert_array_equal(back["pos_embedding"], table)

    cot = rng.standard_normal((length, dim)).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(ref.apply({"params": p}, length)
                                       * cot))(params)["pos_embedding"]
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(mod.pos_embedding.grad.numpy(),
                                  np.asarray(jgrad))


@pytest.mark.parametrize("timer", [JCTTimer, JaxJCTTimer],
                         ids=["port", "jax"])
def test_jct_timer_measures_and_lets_exceptions_through(timer):
    """JCTTimer sets .jct to the block's wall seconds and returns False
    from __exit__, as JAX's: an exception leaves the block, .jct set."""
    with timer() as t:
        time.sleep(0.05)
    assert 0.045 <= t.jct < 5.0  # time.time's wall clock, not monotonic
    with pytest.raises(ValueError, match="through"):
        with timer() as t:
            raise ValueError("through")
    assert 0.0 <= t.jct < 5.0
    t = timer()
    t.__enter__()
    assert t.__exit__(None, None, None) is False
