"""The port's training path against the JAX package's, on the CPU.

The same weights go into both packages (the port's parameters, buffers
included, exported to the JAX package's flat names) and the same numpy
inputs through both; JAX's Pallas kernels run as its own tests run them (in
interpret mode, or through their references).  Tolerances:

- kernels and plain ops: 1e-5 of the largest magnitude (fp32, summation
  order only);
- modules and losses: 1e-4 (fp32; the two frameworks sum in other orders);
- one feat, pix and eval step from shared params, batch and JAX's noise
  draw: logs within 1e-4 relative, per-leaf gradients within 1e-3 of their
  norm; after Adam's first step, its moments per leaf as its gradient, and
  each parameter within 0.1 * lr of JAX's wherever the gradient is clear of
  the two packages' difference (there its sign agrees, and the step is
  lr * g / (|g| + eps)); frozen parameters bit-identical; discrete outputs
  (VQ indices) exactly.

The options a reference YAML reaches (``tune_titok``, the vanilla
discriminator loss, the pix stage's alignment anchor, the rate hinge's
weight under an active floor, the TiTok commitment weight) are held to
the JAX steps by the same limits, in one feat step and one pix step that
turn them on together.
"""
import dataclasses

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp
import optax

from sic_tpu_torch import config as tcfg
from sic_tpu_torch import ops
from sic_tpu_torch.weights import export_flax_params

TOL = 1e-4
LR = 1e-4
DISC = dict(disc_ndf=16, disc_num_layers=2)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(a, b, tol):
    """max |a - b| within ``tol`` of the largest |b|."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max() / scale
    assert err <= tol, err


def _vars(module):
    """The module's exported parameters (and batch statistics) as flax
    variable collections."""
    return unflatten_dict(export_flax_params(module), sep="/")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)


# -- kernels ------------------------------------------------------------------

@pytest.mark.parametrize("nB", [1, 4])
def test_window_attention_bwd_matches_jax(nB):
    """B = 2, 2x2 windows of 4x4: the port's backward (its plain version's
    autograd on the CPU) against the Pallas backward in interpret mode and
    against ``jax.vjp`` of ``_nhwc_reference``; nB = nW carries -inf shift
    masks."""
    from sic_tpu.ops.window_attention import _nhwc_bwd_pallas, _nhwc_reference
    from sic_tpu_torch.models.swin import _full_shift_mask
    qkv, g = _x((2, 8, 8, 24), 1), _x((2, 8, 8, 8), 2)
    bias = _x((nB, 16, 16), 3)
    if nB > 1:
        bias = bias + _full_shift_mask(2, 2, 4)
    dq, db = ops.window_attention_nhwc_bwd(_t(qkv), _t(bias), _t(g), 0.5, 2)
    assert db.shape == (nB, 16, 16)
    pallas = _nhwc_bwd_pallas(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(g),
                              0.5, 2, interpret=True)
    _, vjp = jax.vjp(lambda a, b: _nhwc_reference(a, b, 0.5, 2),
                     jnp.asarray(qkv), jnp.asarray(bias))
    for want_q, want_b in (pallas, vjp(jnp.asarray(g))):
        _rel(dq, want_q, 1e-5)
        _rel(db, want_b, 1e-5)


def test_window_attention_bwd_rejects_a_partly_shared_bias():
    with pytest.raises(ValueError, match="bias rows"):
        ops.window_attention_nhwc_bwd(_t(_x((1, 8, 8, 24), 1)), _t(_x((2, 16, 16), 2)),
                                      _t(_x((1, 8, 8, 8), 3)), 0.5, 2)


def test_seq_attention_gradient_matches_jax():
    from sic_tpu.ops.seq_attention import _seq_attn_reference
    qkv, g = _x((2, 17, 24), 4), _x((2, 17, 8), 5)
    a = _t(qkv, grad=True)
    (got,) = torch.autograd.grad(ops.seq_attention(a, 0.5, 2), a, _t(g))
    _, vjp = jax.vjp(lambda t: _seq_attn_reference(t, 0.5, 2), jnp.asarray(qkv))
    _rel(got, vjp(jnp.asarray(g))[0], 1e-5)


# -- entropy ------------------------------------------------------------------

def test_lower_bound_gates_the_gradient():
    """The gradient passes where x >= bound, or where it pushes x up."""
    from sic_tpu.entropy.gaussian import lower_bound as jlb
    from sic_tpu_torch.entropy.gaussian import lower_bound
    x = np.array([0.1, 0.1, 0.5, 0.9, 0.9], np.float32)
    g = np.array([1.0, -1.0, 1.0, 1.0, -1.0], np.float32)
    a = _t(x, grad=True)
    y = lower_bound(a, 0.5)
    (got,) = torch.autograd.grad(y, a, _t(g))
    _, vjp = jax.vjp(lambda t: jlb(t, 0.5), jnp.asarray(x))
    np.testing.assert_array_equal(_np(y), np.maximum(x, 0.5))
    np.testing.assert_array_equal(_np(got), np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(_np(got), [0.0, -1.0, 1.0, 1.0, -1.0])


@pytest.mark.parametrize("training", [True, False])
def test_gaussian_bits_matches_jax(training):
    from sic_tpu.entropy.gaussian import gaussian_bits as jbits
    from sic_tpu_torch.entropy.gaussian import gaussian_bits
    y = _x((4, 64), 6, 3.0)
    sigma = np.exp(_x((4, 64), 7, 2.0)).astype(np.float32)
    sigma[0, :4] = [0.0, 1e-6, 0.11, 0.12]
    a, s = _t(y, grad=True), _t(sigma, grad=True)
    bits = gaussian_bits(a, s, training)
    got = torch.autograd.grad(bits.sum(), (a, s))
    want_bits = jbits(jnp.asarray(y), jnp.asarray(sigma), training)
    want = jax.grad(lambda u, v: jnp.sum(jbits(u, v, training)), (0, 1))(
        jnp.asarray(y), jnp.asarray(sigma))
    _rel(bits, want_bits, TOL)
    for a_, b_ in zip(got, want):
        _rel(a_, b_, TOL)


def _named(module):
    from sic_tpu_torch.weights import named_flax_params
    return list(named_flax_params(module))


def _leaf_layout(t, key):
    """A port tensor of leaf ``key`` in the JAX package's layout."""
    a = _np(t)
    if key.endswith("/kernel") and a.ndim == 2:
        return a.T
    if key.endswith("/kernel") and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a


def _floor(grads) -> float:
    """1e-6 of the whole gradient's norm: the absolute floor for leaves
    whose exact gradient is 0 (a key bias shifts a whole softmax row; a
    bias right before a one-channel GroupNorm group cancels), which both
    frameworks round to noise."""
    return 1e-6 * float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                                    for g in grads)))


def _grad_close(got, want, key, floor, tol=1e-3):
    """A gradient within ``tol`` of the JAX gradient's norm."""
    want = np.asarray(want, np.float64)
    got = np.zeros_like(want) if got is None else _leaf_layout(got, key).astype(np.float64)
    norm, diff = np.linalg.norm(want), np.linalg.norm(got - want)
    assert diff <= tol * norm + floor, (key, diff, norm)


def _compare_grads(module, jgrads):
    flat = {"params/" + "/".join(k): v for k, v in flatten_dict(jgrads).items()}
    floor = _floor(flat.values())
    for k, p in _named(module):
        _grad_close(p.grad, flat[k], k, floor)


def test_bottleneck_training_forward_with_injected_noise():
    """The four-part training forward (straight-through rounding, gated
    quant step) and both rates, with JAX's noise draw fed to the port;
    values and every parameter's gradient."""
    from sic_tpu.models.bottleneck import CompressiveBottleneck as JB
    from sic_tpu_torch.models.bottleneck import CompressiveBottleneck
    from test_torch_bottleneck import _randomize
    m = _randomize(CompressiveBottleneck(64, 16), 8).requires_grad_(True)
    y = _x((2, 8, 8, 64), 9, 3.0)
    key = jax.random.PRNGKey(3)
    noise = jax.random.uniform(key, (2, 8, 8, 16), jnp.float32, -0.5, 0.5)
    params = _vars(m)

    def jloss(p):
        y_hat, r = JB(64, 16).apply({"params": p}, jnp.asarray(y), (256, 256),
                                    training=True, noise_rng=key)
        return r["bpp"] + jnp.mean(y_hat ** 2), (y_hat, r)

    (_, (jy, jr)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["params"])
    y_hat, r = m(_t(y), (256, 256), training=True, noise=_t(noise))
    loss = r["bpp"] + torch.mean(y_hat ** 2)
    loss.backward()
    _rel(y_hat, jy, TOL)
    for k in ("bpp", "bpp_direct", "bpp_noise"):
        _rel(r[k], jr[k], TOL)
    _compare_grads(m, jg)
    with torch.no_grad():
        y_ev, r_ev = m(_t(y), (256, 256), training=False)
    jy_ev, jr_ev = JB(64, 16).apply(params, jnp.asarray(y), (256, 256))
    _rel(y_ev, jy_ev, TOL)
    _rel(r_ev["bpp"], jr_ev["bpp"], TOL)


def test_quantizer_losses_match_jax():
    """Straight-through z_q, the commitment and codebook losses, indices
    exactly; the gradient reaching z."""
    from sic_tpu.models.quantizer import L2VectorQuantizer as JL2
    from sic_tpu.models.quantizer import VQGANQuantizer as JVQ
    from sic_tpu_torch.models.quantizer import L2VectorQuantizer, VQGANQuantizer
    from test_torch_modules import _randomize
    w = _x((6, 8, 8), 10)
    m = _randomize(L2VectorQuantizer(64, 8), 11)
    z = _t(_x((6, 8, 8), 12), grad=True)
    z_q, r = m(z)
    got = torch.autograd.grad(torch.sum(z_q * _t(w)) + r["quantizer_loss"], z)[0]

    def jf(t):
        zq, info = JL2(64, 8).apply(_vars(m), t)
        return jnp.sum(zq * w) + info["quantizer_loss"], (zq, info)

    (_, (jzq, info)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(_np(z)))
    _rel(z_q, jzq, TOL)
    _rel(got, jg, TOL)
    np.testing.assert_array_equal(_np(r["min_encoding_indices"]),
                                  np.asarray(info["min_encoding_indices"]))
    for k in ("quantizer_loss", "commitment_loss", "codebook_loss"):
        _rel(r[k], info[k], TOL)

    vq = _randomize(VQGANQuantizer(64, 16), 13)
    h = _x((1, 4, 4, 16), 14, 0.05)
    zq2, loss2, info2 = vq(_t(h))
    jzq2, jloss2, jinfo2 = JVQ(64, 16).apply(_vars(vq), jnp.asarray(h))
    _rel(zq2, jzq2, TOL)
    _rel(loss2, jloss2, TOL)
    np.testing.assert_array_equal(_np(info2["indices"]), np.asarray(jinfo2["indices"]))


def test_teacher_encode_to_vqgan_matches_jax():
    """The VQGAN teacher encoder (Downsample's (0, 1) pad, the attention at
    16 px) and its quantizer: latents within 1e-4, indices exactly."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.codec import Codec as JCodec
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.weights import init_seeded
    m = Codec(tcfg.tiny_spec())
    init_seeded(m, 3)
    x = np.random.default_rng(15).random((1, 256, 256, 3)).astype(np.float32) * 2 - 1
    with torch.no_grad():
        lat, idx = m.encode_to_vqgan(_t(x))
    jlat, jidx = jax.jit(lambda v, t: JCodec(jtiny()).apply(
        v, t, method=JCodec.encode_to_vqgan))(_vars(m), jnp.asarray(x))
    assert tuple(idx.shape) == (1, 16, 16)
    _rel(lat, jlat, TOL)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    assert len(np.unique(_np(idx))) > 4


# -- discriminator, LPIPS, metrics, losses --------------------------------------

def test_discriminator_and_its_batch_stats_match_jax():
    """Train-mode logits from batch statistics; the flax update rule (real
    then fake, biased variance, 0.9 momentum) on the running statistics;
    eval-mode logits from them; the parameters' gradients."""
    from sic_tpu.models.discriminator import NLayerDiscriminator as JD
    from sic_tpu_torch.models.discriminator import NLayerDiscriminator
    d = NLayerDiscriminator(16, 2)
    d.init_weights(torch.Generator().manual_seed(0))
    v0 = _vars(d)
    real, fake = _x((2, 64, 64, 3), 16), _x((2, 64, 64, 3), 17)
    lr_ = d(_t(real), train=True, update_stats=True)
    lf_ = d(_t(fake), train=True, update_stats=True)
    (lr_.mean() - lf_.mean()).backward()
    jd = JD(ndf=16, n_layers=2)

    def jf(p):
        a, mut = jd.apply({"params": p, "batch_stats": v0["batch_stats"]},
                          jnp.asarray(real), train=True, mutable=["batch_stats"])
        b, mut = jd.apply({"params": p, "batch_stats": mut["batch_stats"]},
                          jnp.asarray(fake), train=True, mutable=["batch_stats"])
        return jnp.mean(a) - jnp.mean(b), (a, b, mut["batch_stats"])

    (_, (ja, jb, jstats)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        v0["params"])
    _rel(lr_, ja, TOL)
    _rel(lf_, jb, TOL)
    flat = flatten_dict(jstats, sep="/")
    for name, buf in d.named_buffers():
        _rel(buf, flat[name.replace(".", "/")], TOL)
    _compare_grads(d, jg)
    with torch.no_grad():
        ev = d(_t(real))
    jev = jd.apply({"params": v0["params"], "batch_stats": jstats}, jnp.asarray(real))
    _rel(ev, jev, TOL)


def test_lpips_and_its_loader_match_jax(tmp_path):
    """The distance on shared seeded weights, and the torch-checkpoint
    loaders of both packages giving the same distance."""
    from sic_tpu.models.lpips import LPIPS as JLPIPS
    from sic_tpu.models.lpips import port_lpips_params
    from sic_tpu_torch.models.lpips import CHANNELS, LPIPS, load_lpips_weights
    lp = LPIPS()
    lp.init_weights(torch.Generator().manual_seed(1))
    x, y = _x((2, 64, 64, 3), 18, 0.5), _x((2, 64, 64, 3), 19, 0.5)
    japply = jax.jit(lambda v: JLPIPS().apply(v, jnp.asarray(x), jnp.asarray(y)))
    _rel(lp(_t(x), _t(y)), japply(_vars(lp)), TOL)

    rng = np.random.default_rng(20)
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32)) for i, c in enumerate(CHANNELS)}
    vgg, n = {}, 0
    for i in range(13):                     # features.<n> with pools between
        conv = getattr(lp.vgg, f"conv_{i}")
        vgg[f"features.{n}.weight"] = 0.9 * conv.weight.detach().clone()
        vgg[f"features.{n}.bias"] = torch.full_like(conv.bias, 0.01)
        n += 3 if i in (1, 3, 6, 9) else 2
    torch.save(lin, tmp_path / "lin.pth")
    torch.save(vgg, tmp_path / "vgg16.pth")
    load_lpips_weights(lp, str(tmp_path / "lin.pth"), str(tmp_path / "vgg16.pth"))
    jparams = port_lpips_params(JLPIPS().init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(y)),
                                str(tmp_path / "lin.pth"), str(tmp_path / "vgg16.pth"))
    _rel(lp(_t(x), _t(y)), japply(jparams), TOL)


def test_metrics_match_jax():
    """PSNR, SSIM and MS-SSIM (with the 1e-4 floor on each factor), and the
    MS-SSIM gradient the msssim loss trains with."""
    from sic_tpu import metrics as jm
    from sic_tpu_torch import metrics
    a = np.clip(_x((2, 192, 192, 3), 21, 0.5), -1, 1)
    b = np.clip(a + _x((2, 192, 192, 3), 22, 0.2), -1, 1)
    b[1] = -a[1]                             # anticorrelated: factors hit the floor
    tb = _t(b, grad=True)
    ms = metrics.ms_ssim(_t(a), tb)
    (g,) = torch.autograd.grad(ms.sum(), tb)
    _rel(ms, jm.ms_ssim(jnp.asarray(a), jnp.asarray(b)), TOL)
    _rel(g, jax.grad(lambda t: jnp.sum(jm.ms_ssim(jnp.asarray(a), t)))(jnp.asarray(b)), TOL)
    _rel(metrics.ssim(_t(a), _t(b)), jm.ssim(jnp.asarray(a), jnp.asarray(b)), TOL)
    _rel(metrics.psnr(_t(a), _t(b)), jm.psnr(jnp.asarray(a), jnp.asarray(b)), TOL)


def test_losses_match_jax():
    from sic_tpu.train import losses as jl
    from sic_tpu_torch.train import losses
    f, t = _x((2, 4, 4, 8), 23), _x((2, 4, 4, 8), 24)
    logits = _x((2, 4, 4, 16), 25)
    labels = np.random.default_rng(26).integers(0, 16, (2, 4, 4))
    got, logs = losses.feat_align_loss(_t(f), _t(logits), _t(t), torch.from_numpy(labels),
                                       torch.tensor(0.3), torch.tensor(0.2), sq_weight=7.2)
    want, jlogs = jl.feat_align_loss(jnp.asarray(f), jnp.asarray(logits), jnp.asarray(t),
                                     jnp.asarray(labels), 0.3, 0.2, sq_weight=7.2)
    _rel(got, want, TOL)
    for k in jlogs:
        _rel(logs[k], jlogs[k], TOL)
    r, fk = _x((2, 6, 6, 1), 27), _x((2, 6, 6, 1), 28)
    _rel(losses.hinge_d_loss(_t(r), _t(fk)), jl.hinge_d_loss(jnp.asarray(r), jnp.asarray(fk)), TOL)
    assert losses.adopt_weight(1.0, 3, 5) == float(jl.adopt_weight(1.0, 3, 5)) == 0.0
    assert losses.adopt_weight(1.0, 5, 5) == float(jl.adopt_weight(1.0, 5, 5)) == 1.0


# -- one step of each kind from shared params ------------------------------------

def _strategy(pkg, floor=0.001):
    """Three one-epoch stages; ``floor``: the first stage's band floor,
    which both states start with as their rate floor."""
    S = pkg.StageSpec
    return pkg.TrainingStrategy(
        learning_rate=LR, start_epoch=0,
        stages=(S(1, 0, (1.0, 2.0), max(2.0, 2 * floor), floor),
                S(1, 0, (1.0, 2.0), 0.012, 0.007),
                S(1, 0, (1.0, 2.0), 0.015, 0.010)))


def _stash():
    """An optax transform that keeps the last gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _make_twins(commitment_cost=0.25, feat_kw=None, img_kw=None,
                tune_titok=False, floor=0.001):
    """(port state factory, JAX state, JAX steps, batch, flat params): the
    tiny spec with seeded weights and an O(1) bottleneck (as trained
    weights keep it; test_torch_bottleneck.py says why), its exported
    params, discriminator and LPIPS in a JAX TrainState whose optimizers
    stash their gradients; both packages under the same options."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models.codec import Codec as JCodec
    from sic_tpu.models.discriminator import NLayerDiscriminator as JD
    from sic_tpu.models.lpips import LPIPS as JLPIPS
    from sic_tpu.train import state as jstate_mod
    from sic_tpu.train.steps import FeatLossCfg as JFeat
    from sic_tpu.train.steps import ImgLossCfg as JImg
    from sic_tpu.train.steps import make_steps
    from sic_tpu_torch import train
    from test_torch_bottleneck import _randomize

    feat_kw, img_kw = feat_kw or {}, dict(DISC, **(img_kw or {}))
    spec = tcfg.tiny_spec(titok=dataclasses.replace(
        tcfg.tiny_spec().titok, commitment_cost=commitment_cost))
    jspec = jtiny(titok=dataclasses.replace(jtiny().titok,
                                            commitment_cost=commitment_cost))
    model, state, _ = train.create_train_state(
        spec, _strategy(train), 0, img_cfg=train.ImgLossCfg(**DISC), device="cpu")
    _randomize(model.hybrid_codec.quantize_feat, 4).requires_grad_(True)
    flat = export_flax_params(model)

    def port_state():
        return train.create_train_state(
            spec, _strategy(train, floor), 0,
            feat_cfg=train.FeatLossCfg(**feat_kw),
            img_cfg=train.ImgLossCfg(**img_kw), device="cpu",
            codec_params=flat, tune_titok=tune_titok)

    params = {"params": unflatten_dict(flat, sep="/")["params"]}
    dv, lv = _vars(state.disc), _vars(state.lpips)
    ae_tx = optax.chain(_stash(), optax.adam(LR, b1=0.5, b2=0.9))
    disc_tx = optax.chain(_stash(), optax.adam(LR, b1=0.5, b2=0.9))
    jsteps = make_steps(JCodec(jspec), JD(ndf=16, n_layers=2), JLPIPS(),
                        JFeat(**feat_kw), JImg(**img_kw), ae_tx, disc_tx,
                        tune_titok=tune_titok)
    trainable, _ = jstate_mod.split_params(params, tune_titok)
    jst = jstate_mod.TrainState(
        params=params, opt_state_ae=ae_tx.init(trainable),
        disc_params=dv["params"], disc_stats=dv["batch_stats"],
        opt_state_disc=disc_tx.init(dv["params"]), lpips_params=lv,
        global_step=jnp.asarray(0, jnp.int32),
        epoch_for_strategy=jnp.asarray(0, jnp.int32),
        lmbda_idx=jnp.asarray(0, jnp.int32),
        lmbda_list=jnp.asarray((1.0, 2.0), jnp.float32),
        rate_floor=jnp.asarray(floor, jnp.float32), rng=jax.random.PRNGKey(5))
    x = np.clip(0.6 * np.sin(np.mgrid[0:256, 0:256][1] / 9.0)[None, :, :, None]
                + _x((1, 256, 256, 3), 30, 0.3), -1, 1).astype(np.float32)
    return port_state, jst, jsteps, x, flat


@pytest.fixture(scope="module")
def twins():
    return _make_twins()


def _jax_noise(jst, shape=(1, 8, 8, 16)):
    _, noise_rng = jax.random.split(jst.rng)
    return jax.random.uniform(noise_rng, shape, jnp.float32, -0.5, 0.5)


def _check_logs(logs, jlogs):
    assert set(jlogs) <= set(logs), set(jlogs) - set(logs)
    for k, v in jlogs.items():
        a, b = float(logs[k]), float(v)
        assert abs(a - b) <= TOL * abs(b) + 1e-7, (k, a, b)


def _adam_close(opt, p, key, want, g, adam, floor):
    """One leaf after Adam's first step against optax's: the step count,
    the gradient and both moments (which carry the betas) within the
    gradient's tolerance, and the parameter within 0.1 * lr of JAX's
    wherever |g| is over twice the two gradients' difference (so that their
    signs agree) and over 100 * eps (so that the step is about lr * sign(g)).
    Returns the number of such elements and of those over 100 * eps."""
    g = np.asarray(g, np.float64)
    st = opt.state[p]
    assert int(st["step"]) == int(adam.count), key
    _grad_close(p.grad, g, key, floor)
    _grad_close(st["exp_avg"], adam.mu[key], key, floor)
    _grad_close(torch.sqrt(st["exp_avg_sq"]), np.sqrt(adam.nu[key]), key, floor)
    big = np.abs(g) > 100 * opt.defaults["eps"]
    clear = big & (np.abs(g) > 2 * np.abs(_leaf_layout(p.grad, key) - g))
    np.testing.assert_allclose(_leaf_layout(p, key)[clear], np.asarray(want)[clear],
                               rtol=0, atol=0.1 * LR, err_msg=key)
    return np.array([clear.sum(), big.sum()])


def _adam_state(opt_state, flat):
    """optax's Adam state of ``chain(_stash(), adam)``, its moments keyed by
    leaf name through ``flat``."""
    adam = opt_state[1][0]
    return adam._replace(mu=flat(adam.mu), nu=flat(adam.nu))


def _codec_leaves(tree):
    """The codec's trainable subtree (flat, keyed by path tuples) by leaf name."""
    return {"params/" + "/".join(k[1:]): v for k, v in tree.items()}


def _check_update(state, jnew, flat):
    """Gradients and Adam's first step per trainable leaf, frozen
    parameters unchanged."""
    jflat = {"params/" + "/".join(k[1:]): v for k, v in
             flatten_dict(jnew.params).items()}
    jgrads = _codec_leaves(jnew.opt_state_ae[0])
    adam = _adam_state(jnew.opt_state_ae, _codec_leaves)
    trainable = {"/".join(path) for path, _ in state.trainable}
    assert trainable == set(jgrads)
    floor = _floor(jgrads.values())
    counts = np.zeros(2, int)
    for k, p in _named(state.model):
        if k not in trainable:
            np.testing.assert_array_equal(_leaf_layout(p, k), flat[k])
            continue
        counts += _adam_close(state.opt_ae, p, k, jflat[k], jgrads[k], adam, floor)
    assert counts[0] > 0.99 * counts[1], counts


def test_feat_step_matches_jax(twins):
    port_state, jst, (feat_step, _, _), x, flat = twins
    jnew, jlogs = feat_step(jst, jnp.asarray(x))
    _, state, steps = port_state()
    logs = steps.feat_step(state, _t(x), noise=_t(_jax_noise(jst)))
    _check_logs(logs, jlogs)
    _check_update(state, jnew, flat)
    assert state.global_step == int(jnew.global_step) == 1
    # the VQGAN decoder side stays put outside stage pix, with a zero
    # gradient (Adam counts the step, as optax does)
    conv_out = state.model.vqgan.decoder.conv_out.weight
    assert torch.count_nonzero(conv_out.grad) == 0
    assert int(state.opt_ae.state[conv_out]["step"]) == 1


def test_pix_step_matches_jax(twins):
    """Generator and discriminator updates, the adaptive weight, the
    discriminator's statistics after its real and fake passes."""
    port_state, jst, (_, pix_step, _), x, flat = twins
    jnew, jlogs = pix_step(jst, jnp.asarray(x))
    _, state, steps = port_state()
    logs = steps.pix_step(state, _t(x), noise=_t(_jax_noise(jst)))
    _check_logs(logs, jlogs)
    _check_update(state, jnew, flat)
    assert float(logs["train/d_weight"]) > 0
    jd = flatten_dict(jnew.opt_state_disc[0], sep="/")
    jdp = flatten_dict(jnew.disc_params, sep="/")
    jds = flatten_dict(jnew.disc_stats, sep="/")
    adam = _adam_state(jnew.opt_state_disc, lambda t: flatten_dict(t, sep="/"))
    floor = _floor(jd.values())
    for k, p in _named(state.disc):
        leaf = k[len("params/"):]
        _adam_close(state.opt_disc, p, leaf, jdp[leaf], jd[leaf], adam, floor)
    for name, buf in state.disc.named_buffers():
        _rel(buf, jds[name.replace(".", "/")], TOL)


def test_eval_step_matches_jax(twins):
    port_state, jst, (_, _, eval_step), x, _ = twins
    jlogs = eval_step(jst, jnp.asarray(x))
    _, state, steps = port_state()
    _check_logs(steps.eval_step(state, _t(x)), jlogs)


# -- the options a reference YAML reaches ----------------------------------------

# a band floor far above the tiny model's noise-proxy rate: the rate hinge
# is active, so its weight shows in the loss
ACTIVE_FLOOR = 50.0


def test_feat_step_options_match_jax():
    """tune_titok (the TiTok backbones train: the trainable set is JAX's
    partition_labels 'ae' leaves), commitment weight 0.5 and the feat
    stage's rate hinge at weight 2 under an active floor."""
    from sic_tpu.train.state import partition_labels
    port_state, jst, (feat_step, _, _), x, flat = _make_twins(
        commitment_cost=0.5, feat_kw=dict(rate_push_w=2.0), tune_titok=True,
        floor=ACTIVE_FLOOR)
    jnew, jlogs = feat_step(jst, jnp.asarray(x))
    _, state, steps = port_state()
    logs = steps.feat_step(state, _t(x), noise=_t(_jax_noise(jst)))
    labels = flatten_dict(partition_labels(jst.params, tune_titok=True), sep="/")
    ae = {k for k, v in labels.items() if v == "ae"}
    assert {"/".join(path) for path, _ in state.trainable} == ae
    assert any("/transformer_" in k for k in ae)          # the backbones train
    assert float(logs["train/rate_push"]) > 0
    _check_logs(logs, jlogs)
    _check_update(state, jnew, flat)


def test_pix_step_options_match_jax():
    """The vanilla (softplus) discriminator loss, the alignment anchor at
    0.5 and the pix stage's rate hinge at weight 2 under an active floor:
    logs, the generator's and the discriminator's gradients and Adam steps."""
    port_state, jst, (_, pix_step, _), x, flat = _make_twins(
        img_kw=dict(disc_loss="vanilla", align_weight=0.5, rate_push_w=2.0),
        floor=ACTIVE_FLOOR)
    jnew, jlogs = pix_step(jst, jnp.asarray(x))
    _, state, steps = port_state()
    logs = steps.pix_step(state, _t(x), noise=_t(_jax_noise(jst)))
    assert "train/pix_align_loss" in jlogs and float(logs["train/rate_push"]) > 0
    _check_logs(logs, jlogs)
    _check_update(state, jnew, flat)
    jd = flatten_dict(jnew.opt_state_disc[0], sep="/")
    jdp = flatten_dict(jnew.disc_params, sep="/")
    adam = _adam_state(jnew.opt_state_disc, lambda t: flatten_dict(t, sep="/"))
    floor = _floor(jd.values())
    for k, p in _named(state.disc):
        leaf = k[len("params/"):]
        _adam_close(state.opt_disc, p, leaf, jdp[leaf], jd[leaf], adam, floor)


def test_vanilla_d_loss_matches_jax():
    from sic_tpu.train import losses as jl
    from sic_tpu_torch.train import losses
    r, fk = _x((2, 6, 6, 1), 40, 3.0), _x((2, 6, 6, 1), 41, 3.0)
    _rel(losses.vanilla_d_loss(_t(r), _t(fk)),
         jl.vanilla_d_loss(jnp.asarray(r), jnp.asarray(fk)), TOL)
    from sic_tpu_torch.train import FeatLossCfg, ImgLossCfg, TrainSteps
    with pytest.raises(ValueError, match="disc_loss"):
        TrainSteps(FeatLossCfg(), ImgLossCfg(disc_loss="wgan"))


# -- schedule, presets, data ----------------------------------------------------

def test_strategy_and_presets_match_jax():
    from sic_tpu import config as jcfg
    for qp in range(4):
        for px in (256, 512):
            assert dataclasses.asdict(tcfg.qp_strategy(qp, px)) == \
                dataclasses.asdict(jcfg.qp_strategy(qp, px))
    s = tcfg.qp_strategy(0, 512)
    assert s.stage_at(0)[0] == "pix"
    s = tcfg.qp_strategy(1, 256)
    assert [s.stage_at(e)[0] for e in (0, 1, 8, 200)] == \
        ["feat_wo_bpp", "feat", "pix", "pix"]
    assert s.adjust_lmbda_idx(1, 0, 1.0) == 1
    assert s.adjust_lmbda_idx(1, 3, 0.0) == 2


def test_frozen_partition_matches_jax():
    """The same leaves are frozen in both packages, and the port gives them
    no gradient and no optimizer state."""
    from sic_tpu.train.state import is_frozen_path as jfrozen
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.train import is_frozen_path, named_codec_params, partition
    m = Codec(tcfg.tiny_spec())
    trainable = {path for path, _ in partition(m)}
    for path, p in named_codec_params(m):
        assert is_frozen_path(path) == jfrozen(path) == (not p.requires_grad)
        assert (path in trainable) == p.requires_grad
    assert any(p[1] == "vqgan" and p[2] == "encoder" for p, _ in named_codec_params(m))


def test_training_crops_match_jax(tmp_path):
    """Random (train) and center (eval) crops of the same files, with the
    JAX package's seeds: the same pixels."""
    from PIL import Image
    from sic_tpu.data import ImageDataset as JDS
    from sic_tpu_torch.data import ImageDataset
    rng = np.random.default_rng(31)
    for i, (h, w) in enumerate(((300, 400), (256, 256), (520, 300))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            tmp_path / f"im{i}.png")
    for train in (True, False):
        a = ImageDataset.from_dir(tmp_path, 256, train)
        b = JDS.from_dir(tmp_path, 256, train)
        for i in range(len(a)):
            np.testing.assert_array_equal(a[i], b[i])
        got = next(a.batches(3, shuffle=False))
        assert got.shape == (3, 256, 256, 3)
