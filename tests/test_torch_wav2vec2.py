"""The port's Wav2Vec2 model and losses against the JAX package, on the CPU.

A tiny config, the JAX model's own initialised parameters converted to the
port (convert.params_from_flax), numpy-seeded inputs, f32, every dropout
rate 0 where the two are compared (the JAX package's dropout bits come from
another generator), and the contrastive negatives injected on both sides
(JAX's PRNG stream cannot be reproduced).  Each test states its tolerance:
two f32 implementations that sum in other orders agree to about 1e-6
relative on a forward, so outputs are held at rtol 1e-5 and gradients at
rtol 1e-4.  The training step, loop and CLIs: test_torch_wav2vec2_jobs.py.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import losses as jax_losses
from tethys_tpu.configs import Wav2Vec2Config as JaxConfig
from tethys_tpu.models import wav2vec2 as jax_w2v
from tethys_tpu.ops.norms import ReferenceGroupNorm as JaxGroupNorm
from tethys_tpu_torch import losses
from tethys_tpu_torch.configs import Wav2Vec2Config
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.ops import conv, norms

from _torch_wav2vec2_common import AUDIO
from _torch_wav2vec2_common import audio as _audio
from _torch_wav2vec2_common import close as _close
from _torch_wav2vec2_common import configs as _configs
from _torch_wav2vec2_common import negatives as _negatives
from _torch_wav2vec2_common import pair as _pair
from _torch_wav2vec2_common import t as _t

torch.set_num_threads(2)



@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_presets_match_jax_field_for_field(size):
    assert (dataclasses.asdict(Wav2Vec2Config.from_size(size))
            == dataclasses.asdict(JaxConfig.from_size(size)))
    assert [f.name for f in dataclasses.fields(Wav2Vec2Config)] == [
        f.name for f in dataclasses.fields(JaxConfig)]
    cfg, jcfg = Wav2Vec2Config.from_size(size), JaxConfig.from_size(size)
    for n in (32000, 80000, 401, 1):
        assert cfg.downsampled_length(n) == jcfg.downsampled_length(n)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        Wav2Vec2Config.from_size(size, scan_layers=True)


@pytest.mark.parametrize("groups,t", [(4, 37), (16, 20)])
def test_group_norm_forward_and_vjp_match_jax(groups, t):
    """Forward and the VJP (dx, dgamma, dbeta) against the JAX module
    through jax.vjp, rtol 1e-5 (atol 1e-5 on dx, whose entries sum ~T*C/G
    terms that cancel)."""
    rng = np.random.default_rng(6)
    x = (3.0 + rng.standard_normal((2, t, 32))).astype(np.float32)
    gamma = rng.standard_normal(32).astype(np.float32)
    beta = rng.standard_normal(32).astype(np.float32)
    dy = rng.standard_normal((2, t, 32)).astype(np.float32)
    jgn = JaxGroupNorm(groups=groups)
    y, vjp = jax.vjp(lambda x, g, b: jgn.apply(
        {"params": {"gamma": g, "beta": b}}, x), *map(jnp.asarray,
                                                      (x, gamma, beta)))
    dx, dg, db = vjp(jnp.asarray(dy))
    gn = norms.ReferenceGroupNorm(32, groups)
    with torch.no_grad():
        gn.gamma.copy_(_t(gamma))
        gn.beta.copy_(_t(beta))
    xt = _t(x).requires_grad_()
    out = gn(xt)
    out.backward(_t(dy))
    _close(out, y, atol=1e-5)
    _close(xt.grad, dx, atol=1e-5, msg="dx")
    _close(gn.gamma.grad, dg, msg="dgamma")
    _close(gn.beta.grad, db, msg="dbeta")
    assert gn.__class__(32, groups, dtype=torch.bfloat16)(_t(x)).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("t,k,stride,groups", [
    (401, 10, 5, 1), (80, 3, 2, 1), (41, 2, 2, 1), (20, 8, 1, 4),
    (100, 128, 1, 16),          # wav2vec2-base's positional conv, pads (63, 64)
])
def test_same_convs_match_flax(t, k, stride, groups):
    c_in = 1 if k == 10 else 32
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, t, c_in)).astype(np.float32)
    layer = fnn.Conv(32, kernel_size=(k,), strides=(stride,), padding="SAME",
                     feature_group_count=groups)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = layer.apply({"params": params}, jnp.asarray(x))
    weight = _t(np.asarray(params["kernel"]).transpose(2, 1, 0))
    got = conv.conv1d_same(_t(x), weight, _t(params["bias"]), stride, groups)
    assert got.shape == want.shape == (2, -(-t // stride), 32)
    _close(got, want, atol=1e-5)
    if k == 128:
        assert conv.same_pad(t, k, stride) == (63, 64)


def _codebook_outputs(quantizer, hidden):
    out = quantizer(hidden)
    return out["indices"], out["codevector_perplexity"], out


@pytest.mark.parametrize("freeze", [True, False])
def test_quantizer_matches_jax(freeze):
    """The same argmin indices (first index on ties) and perplexity as JAX;
    frozen codevectors get no gradient, trained ones the one-hot's."""
    jcfg, cfg = _configs(freeze_codevectors=freeze)
    hidden = np.random.default_rng(8).standard_normal(
        (2, 20, cfg.hidden_size)).astype(np.float32)
    jq = jax_w2v.Wav2Vec2Quantizer(jcfg)
    params = jq.init(jax.random.PRNGKey(1), jnp.asarray(hidden))["params"]
    want = jq.apply({"params": params}, jnp.asarray(hidden))
    q = w2v.Wav2Vec2Quantizer(cfg)
    q.load_state_dict(params_from_flax(jax.device_get(params)))
    assert q.codevectors.requires_grad == (not freeze)
    indices, perplexity, out = _codebook_outputs(q, _t(hidden))
    np.testing.assert_array_equal(
        indices.numpy(), np.asarray(jnp.argmin(want["distances"], axis=-1)))
    _close(perplexity, want["codevector_perplexity"])
    _close(out["quantized_features"], want["quantized_features"])
    _close(out["distances"], want["distances"], atol=1e-4)
    if freeze:
        assert not out["quantized_features"].requires_grad
    else:
        out["quantized_features"].sum().backward()
        g = jax.grad(lambda p: jq.apply({"params": p}, jnp.asarray(hidden))[
            "quantized_features"].sum())(params)["codevectors"]
        _close(q.codevectors.grad, g)
    assert q.project_to_codevector_dim.weight.grad is None   # argmin
    tie = torch.zeros(1, 1, cfg.hidden_size)
    with torch.no_grad():
        q.codevectors.zero_()
    assert (_codebook_outputs(q, tie)[0] == 0).all()


@pytest.mark.parametrize("stable,weighted", [(True, False), (False, False),
                                             (True, True)])
def test_feature_extractor_and_encoder_match_jax(stable, weighted):
    """The conv feature encoder (GroupNorm, GELU, positional conv) and the
    pre-/post-LN encoder with and without the weighted layer sum, in eval
    mode and, with the quantizer, in train mode; rtol 1e-5 / atol 1e-5."""
    jcfg, cfg = _configs(do_stable_layer_norm=stable,
                         use_weighted_layer_sum=weighted)
    jmodel = jax_w2v.Wav2Vec2Model(jcfg)
    audio = _audio()
    params = jmodel.init({"params": jax.random.PRNGKey(2)},
                         jnp.asarray(audio), training=True)["params"]
    port = w2v.Wav2Vec2Model(cfg)
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    mask = np.ones((2, cfg.downsampled_length(AUDIO)), np.int32)
    mask[1, 13:] = 0
    for training, m in ((False, None), (True, None), (False, mask)):
        want = jmodel.apply({"params": params}, jnp.asarray(audio),
                            attention_mask=None if m is None else jnp.asarray(m),
                            training=training, deterministic=True)
        got = port.train(training)(_t(audio),
                                   None if m is None else _t(m))
        for key in ("extract_features", "last_hidden_state") + (
                ("quantized_features", "codevector_perplexity")
                if training else ()):
            _close(got[key], want[key], atol=1e-5, msg=key)
    assert set(dict(port.named_parameters())) == set(
        params_from_flax(jax.device_get(params)))


def test_heads_match_jax():
    """The three heads' outputs: the pretraining projections, CTC logits and
    both CTC losses, classification logits (mean and masked pooling) and
    loss; rtol 1e-5 / atol 1e-5."""
    audio = _audio()
    jmodel, params, port, _ = _pair("pretraining")
    want = jmodel.apply({"params": params}, jnp.asarray(audio),
                        training=True, deterministic=True)
    got = port(_t(audio))
    for key in ("projected_states", "projected_quantized_features"):
        _close(got[key], want[key], atol=1e-5, msg=key)
    labels = np.array([[3, 5, 2, 0], [1, 4, 0, 0]], np.int32)
    for real in (False, True):
        jmodel, params, port, _ = _pair("asr", real_ctc=real)
        want = jmodel.apply({"params": params}, jnp.asarray(audio),
                            labels=jnp.asarray(labels), training=True,
                            deterministic=True)
        got = port(_t(audio), labels=_t(labels))
        _close(got["logits"], want["logits"], atol=1e-5)
        _close(got["loss"], want["loss"], msg=f"real_ctc={real}")
    jmodel, params, port, cfg = _pair("classification")
    mask = np.ones((2, cfg.downsampled_length(AUDIO)), np.int32)
    mask[0, 9:] = 0
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        want = jmodel.apply({"params": params}, jnp.asarray(audio),
                            attention_mask=jm,
                            labels=jnp.asarray([1, 2]), training=True,
                            deterministic=True)
        got = port(_t(audio), attention_mask=tm, labels=torch.tensor([1, 2]))
        _close(got["logits"], want["logits"], atol=1e-5)
        _close(got["loss"], want["loss"])


def test_pretraining_loss_and_gradients_match_jax():
    """Loss on injected negatives at 1e-5 relative.  Gradients at rtol 1e-4
    and atol 5e-6 of the tensor's largest gradient: at temperature 0.1 they
    reach ~16, and two f32 chains through the conv stack differ by up to
    ~2e-6 of that scale in every tensor.  A gradient that is zero but for
    rounding (a key bias, which softmax does not see; project_q's LayerNorm
    bias) is held below 1e-6 of the largest gradient on both sides.  The
    frozen codevectors and the quantizer's input projection (behind
    argmin) get none, as JAX's are exactly 0."""
    jmodel, params, port, cfg = _pair("pretraining")
    audio, neg = _audio(), _negatives(cfg)

    def jax_loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(audio), training=True,
                           deterministic=True)
        _, c = jax_losses.contrastive_loss(
            out["projected_states"], out["projected_quantized_features"],
            None, num_negatives=cfg.num_negatives,
            temperature=cfg.contrastive_logits_temperature,
            negative_indices=jnp.asarray(neg))
        return c + cfg.diversity_loss_weight * jax_losses.diversity_loss(
            out["codevector_perplexity"])

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    loss, aux = w2v.pretraining_loss(cfg, port(_t(audio)),
                                     negative_indices=_t(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert aux["logits"].shape == (2, 20, 1 + cfg.num_negatives)
    want = params_from_flax(jax.device_get(want_grads))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    top = max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        if "quantizer" in name:
            assert got[name].grad is None and not g.any(), name
            continue
        scale = g.abs().max().item()
        if scale < 1e-6 * top:
            assert got[name].grad.abs().max() < 1e-6 * top, name
            continue
        _close(got[name].grad, g, rtol=1e-4, atol=5e-6 * scale, msg=name)


def test_negative_sampler_contract():
    gen = torch.Generator().manual_seed(0)
    idx = losses.sample_negative_indices(gen, 3, 100, 100)
    assert idx.shape == (3, 100) and idx.dtype == torch.int64
    assert ((0 <= idx) & (idx < 100)).all()
    for row in idx:                       # 99 distinct, repeat-tiled to 100
        assert len(set(row[:99].tolist())) == 99 and row[99] == row[0]
    again = losses.sample_negative_indices(torch.Generator().manual_seed(0),
                                           3, 100, 100)
    assert torch.equal(idx, again)
    assert losses.sample_negative_indices(gen, 2, 1, 4).eq(0).all()


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("zero_infinity", [False, True])
def test_ctc_loss_matches_jax(reduction, zero_infinity):
    """F.ctc_loss against optax through tethys_tpu.losses.ctc_loss, with and
    without a frame mask, rtol 1e-5; and its gradient."""
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 30, 7)).astype(np.float32) * 2
    labels = np.array([[1, 2, 3, 0, 0], [4, 4, 0, 0, 0], [6, 1, 6, 2, 5]],
                      np.int32)
    mask = np.ones((3, 30), np.int32)
    mask[1, 20:] = 0
    for m in (None, mask):
        want, jgrad = jax.value_and_grad(lambda lg: jax_losses.ctc_loss(
            lg, jnp.asarray(labels),
            attention_mask=None if m is None else jnp.asarray(m),
            zero_infinity=zero_infinity, reduction=reduction))(
                jnp.asarray(logits))
        lt = _t(logits).requires_grad_()
        got = losses.ctc_loss(lt, _t(labels),
                              attention_mask=None if m is None else _t(m),
                              zero_infinity=zero_infinity,
                              reduction=reduction)
        got.backward()
        _close(got, want)
        _close(lt.grad, jgrad, rtol=1e-4, atol=1e-5)
    # An impossible alignment (3 labels, 1 frame) is inf, zeroed on request.
    short = losses.ctc_loss(_t(logits[:1, :1]), _t(labels[:1]),
                            zero_infinity=zero_infinity, reduction=reduction)
    assert short.item() == (0.0 if zero_infinity else float("inf"))


def test_dummy_ctc_and_classification_losses_match_jax():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 9, 5)).astype(np.float32)
    _close(losses.dummy_ctc_loss(_t(logits)),
           jax_losses.dummy_ctc_loss(jnp.asarray(logits)))
    labels = np.array([4, 0], np.int32)
    _close(losses.classification_loss(_t(logits[:, 0]), _t(labels)),
           jax_losses.classification_loss(jnp.asarray(logits[:, 0]),
                                          jnp.asarray(labels)))


@pytest.mark.parametrize("kind", ["pretraining", "asr", "classification"])
def test_converter_maps_every_leaf(kind):
    _, params, port, _ = _pair(kind, use_weighted_layer_sum=True)
    state = params_from_flax(params)
    flat = jax.tree_util.tree_leaves(params)
    assert len(state) == len(flat)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    jp = params["wav2vec2"]["feature_extractor"]["pos_conv_embed"]["kernel"]
    np.testing.assert_array_equal(
        state["wav2vec2.feature_extractor.pos_conv_embed.weight"].numpy(),
        np.asarray(jp).transpose(2, 1, 0))
    assert "wav2vec2.encoder.layer_weights" in state
    assert "wav2vec2.feature_extractor.norm_0.gamma" in state
