"""Training as the JAX package trains on an accelerator, on the CPU.

The same numpy inputs and weights go through the port and the JAX package:

- ``Linear``, ``Conv2d`` and the TiTok VQ search in the two storage /
  compute cases training adds (f32 parameters computed in bf16: flax's
  ``dtype=bf16``; bf16-stored frozen parameters computed in f32: flax's
  ``dtype=None`` with bf16 parameters, which promotion upcasts), against
  flax modules built the same way: outputs within one bf16 ulp of each
  element plus 1e-3 of the largest in bf16 and 1e-6 in f32, gradients
  within 1e-2 of the largest in bf16, VQ indices exactly;
- the bf16-moment Adam against ``optax.adam(mu_dtype=bf16)`` over three
  steps: mu bit-equal in bf16, parameters within 1e-6 relative;
- the leaves ``cast_frozen_params`` stores in bf16, and their dtypes,
  against the JAX package's;
- rematerialisation: one step with ``remat=True`` equal to the step
  without (losses and gradients bit for bit);
- the TensorBoard writer's files read back by the JAX package's reader;
- the train CLI's accelerator rule, ``--log_dir``, ``--no_donate`` and
  ``--f32_frozen``;
- the checkpoint converter in both directions;
- the reference's CLI flags (``--gpu_idx``, ``--bpe_path``,
  ``--stream_part``) and ``SIC_STREAM_PART``; ``profile_trace`` and
  ``timed_stage`` (``timer=`` on the runtime's four entry points is
  held to the JAX runtime's stage names in tests/test_torch_bf16.py).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp
import optax

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.weights import export_flax_params
from test_torch_train import _within_bf16_ulp
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
TINY_YAML = ROOT / "tests" / "fixtures" / "config_tiny.yaml"
BF16 = torch.bfloat16



def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b, tol):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, err


# -- layers in the two new storage / compute cases ---------------------------


def _case(module, params, case):
    """The port module and the flax parameters of one case: "compute"
    (f32 parameters, bf16 compute) or "storage" (bf16 parameters, f32
    compute)."""
    from sic_tpu_torch.models.layers import set_compute_dtype
    if case == "compute":
        set_compute_dtype(module, BF16)
        return module, params
    for p in module.parameters():
        p.data = p.data.to(BF16)
    return module, jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)


def _f64_grads(port, x, r):
    """The exact gradients of sum(port(x) * r) at the module's stored
    parameters rounded as the case computes them, in f64: the yardstick
    both frameworks' bf16 gradients are measured against."""
    import copy

    from sic_tpu_torch.models.layers import set_compute_dtype
    ref = set_compute_dtype(copy.deepcopy(port).double(), torch.float64)
    for p, q in zip(port.parameters(), ref.parameters()):
        q.data = p.detach().to(BF16).double()
        q.grad = None
    xb = torch.from_numpy(x).to(BF16).double()
    (ref(xb) * torch.from_numpy(r).to(BF16).double()).sum().backward()
    return {n: p.grad for n, p in ref.named_parameters()}


@pytest.mark.parametrize("case", ["compute", "storage"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_layers_in_both_cases_match_flax(kind, case):
    """compute: outputs within one bf16 ulp plus 1e-3 of the largest, and
    each f32 parameter's gradient no farther from the exact (f64) gradient
    than twice the JAX package's (a bf16 backward sums in bf16 in XLA, in
    f32 in torch).  storage: f32 outputs within 1e-6, the bf16 gradients
    (f32 sums rounded once) within one bf16 ulp plus 1e-3."""
    import flax.linen as nn

    from sic_tpu_torch.models.layers import Conv2d, Linear
    torch.manual_seed(0)
    jdt = jnp.bfloat16 if case == "compute" else None
    if kind == "linear":
        port, jmod, x = Linear(24, 40), nn.Dense(40, dtype=jdt), _x((3, 5, 24), 1)
    else:
        port, jmod, x = Conv2d(8, 16, 3), nn.Conv(16, (3, 3), dtype=jdt), _x((2, 6, 6, 8), 1)
    params = unflatten_dict(export_flax_params(port), sep="/")["params"]
    port, params = _case(port.requires_grad_(True), params, case)
    r = _x(jmod.apply({"params": params}, jnp.asarray(x)).shape, 2)

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    out = port(torch.from_numpy(x))
    (out.float() * torch.from_numpy(r)).sum().backward()
    want = jnp.bfloat16 if case == "compute" else jnp.float32
    assert jout.dtype == want and str(out.dtype) == f"torch.{jnp.dtype(want).name}"
    if case == "compute":
        _within_bf16_ulp(out, jout)
    else:
        _rel(out, jout, 1e-6)
    exact = _f64_grads(port, x, r) if case == "compute" else None
    for leaf, name in (("kernel", "weight"), ("bias", "bias")):
        got = getattr(port, name).grad
        assert got.dtype == (BF16 if case == "storage" else torch.float32)
        jg = _np(jgrad[leaf])
        if jg.ndim == 2:
            jg = jg.T
        elif jg.ndim == 4:
            jg = jg.transpose(3, 2, 0, 1)
        if case == "storage":
            _within_bf16_ulp(got, jg)
            continue
        ref = exact[name].numpy()
        e_port, e_jax = (np.abs(a - ref).max() for a in (_np(got), jg))
        assert e_port <= 2 * e_jax + 1e-6 * np.abs(ref).max(), (leaf, e_port, e_jax)


@pytest.mark.parametrize("case", ["compute", "storage"])
def test_vq_search_in_both_cases_matches_flax(case):
    """The TiTok quantizer: bf16 latents into the f32 codebook (compute),
    or f32 latents against the codebook stored in bf16 (storage), whose
    l2-normalised rows the search sees upcast: the same indices as the JAX
    package's.  Losses within 1e-5 (compute); with the codebook stored in
    bf16 both packages normalise it in bf16, rounding at other steps (XLA
    each step, torch's norm once from an f32 sum), its rows within two bf16
    ulps of each other, and the losses within 1e-3 (storage)."""
    from sic_tpu.models.quantizer import L2VectorQuantizer as JQ
    from sic_tpu_torch.models.quantizer import L2VectorQuantizer
    torch.manual_seed(3)
    q = L2VectorQuantizer(512, 12)
    z = _x((4, 64, 12), 4)
    params = {"embedding": jnp.asarray(_np(q.embedding))}
    if case == "compute":
        zt, zj = torch.from_numpy(z).to(BF16), jnp.asarray(z, jnp.bfloat16)
    else:
        q.embedding.data = q.embedding.data.to(BF16)
        params = {"embedding": params["embedding"].astype(jnp.bfloat16)}
        zt, zj = torch.from_numpy(z), jnp.asarray(z)
    zq, res = q(zt)
    jzq, jres = JQ(512, 12).apply({"params": params}, zj)
    np.testing.assert_array_equal(_np(res["min_encoding_indices"]),
                                  np.asarray(jres["min_encoding_indices"]))
    assert str(zq.dtype) == f"torch.{jnp.dtype(jzq.dtype).name}"
    if case == "compute":
        _rel(res["quantizer_loss"], jres["quantizer_loss"], 1e-5)
        return
    jcb = JQ(512, 12).apply({"params": params}, method=JQ.codebook)
    assert q.codebook().dtype == BF16 and jcb.dtype == jnp.bfloat16
    _within_bf16_ulp(q.codebook(), jcb, share=0.0, ulps=2)
    _rel(res["quantizer_loss"], jres["quantizer_loss"], 1e-3)


# -- the optimizer and the frozen partition -----------------------------------


def test_moment_dtype_adam_matches_optax():
    from sic_tpu_torch.train import MomentDtypeAdam
    shapes = [(7, 5), (33,), (2, 3, 4)]
    params = [_x(s, 10 + i) for i, s in enumerate(shapes)]
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = MomentDtypeAdam(tp, 1e-3, mu_dtype=BF16)
    tx = optax.adam(1e-3, b1=0.5, b2=0.9, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    for step in range(3):
        grads = [_x(s, 100 * step + i, 10.0 ** (i - 1)) for i, s in enumerate(shapes)]
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, st = tx.update([jnp.asarray(g) for g in grads], st, jp)
        jp = optax.apply_updates(jp, upd)
    adam = st[0]
    for p, j, mu, nu in zip(tp, jp, adam.mu, adam.nu):
        s = opt.state[p]
        assert s["exp_avg"].dtype == BF16 and mu.dtype == jnp.bfloat16
        np.testing.assert_array_equal(s["exp_avg"].view(torch.int16).numpy(),
                                      np.asarray(mu).view(np.int16))
        _rel(s["exp_avg_sq"], nu, 1e-6)
        _rel(p, j, 1e-6)
    assert int(adam.count) == opt.state[tp[0]]["step"] == 3
    # a checkpoint round trip keeps the moments in bf16, and a
    # torch.optim.Adam checkpoint (the f32 moments) resumes in it and back
    again = MomentDtypeAdam([torch.zeros_like(p) for p in tp], 1e-3, mu_dtype=BF16)
    again.load_state_dict(opt.state_dict())
    assert all(s["exp_avg"].dtype == BF16 for s in again.state.values())
    from sic_tpu_torch.train import make_optimizer
    f32 = make_optimizer(tp, 1e-3)
    f32.load_state_dict(opt.state_dict())
    again.load_state_dict(f32.state_dict())
    for p in again.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    again.step()
    assert all(s["exp_avg"].dtype == BF16 and int(s["step"]) == 4
               for s in again.state.values())


def test_cast_frozen_params_matches_jax():
    from sic_tpu.train.state import cast_frozen_params as jcast
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.train import cast_frozen_params, named_codec_params
    for tune in (False, True):
        m = Codec(tcfg.tiny_spec())
        tree = unflatten_dict(export_flax_params(m), sep="/")
        want = {"/".join(k): v.dtype for k, v in
                flatten_dict(jcast(tree, jnp.bfloat16, tune)).items()}
        cast_frozen_params(m, BF16, tune)
        got = {"/".join(k): p.dtype for k, p in named_codec_params(m)}
        assert set(got) == set(want)
        for k, dt in got.items():
            assert (dt == BF16) == (want[k] == jnp.bfloat16), k
        names = {k for k, dt in got.items() if dt == BF16}
        assert "params/hybrid_codec/latent_tokens" in names
        assert "params/hybrid_codec/quantize/embedding" in names
        assert any(k.startswith("params/vqgan/encoder/") for k in names)
        assert any("/quant_conv/" in k for k in names)
        assert any("/transformer_0/ln_1/" in k for k in names) != tune


# -- steps ----------------------------------------------------------------------


def _tiny_state(**kw):
    from sic_tpu_torch import train
    S = train.StageSpec
    strategy = train.TrainingStrategy(
        learning_rate=1e-4, start_epoch=0,
        stages=(S(1, 0, (1.0, 2.0), 2.0, 0.001), S(1, 0, (1.0, 2.0), 0.012, 0.007),
                S(1, 0, (1.0, 2.0), 0.015, 0.010)))
    return train.create_train_state(
        kw.pop("spec", tcfg.tiny_spec()), strategy, 0, device="cpu",
        img_cfg=train.ImgLossCfg(disc_ndf=16, disc_num_layers=2,
                                 perceptual="msssim"), **kw)


def test_remat_step_equals_the_plain_step():
    """One pix step with remat and one without from the same state and
    noise (bf16 compute, bf16 moments and frozen leaves, as on the card):
    every log and every trainable gradient bit for bit."""
    x = torch.from_numpy(np.clip(_x((1, 256, 256, 3), 30, 0.5), -1, 1))
    noise = torch.from_numpy(np.random.default_rng(5).uniform(
        -0.5, 0.5, (1, 8, 8, 16)).astype(np.float32))
    runs = []
    for remat in (False, True):
        kw = dict(dtype=BF16, mu_dtype=BF16, frozen_dtype=BF16)
        model, state, steps = _tiny_state(
            spec=dataclasses.replace(tcfg.tiny_spec(), remat=remat), **kw)
        assert model.hybrid_codec.encoder.remat is remat
        logs = steps.pix_step(state, x, noise=noise)
        runs.append((logs, [p.grad.clone() for _, p in state.trainable]))
    (a, ga), (b, gb) = runs
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for u, v in zip(ga, gb):
        assert torch.equal(u, v)


def test_bf16_state_dtypes_and_checkpoint(tmp_path):
    """create_train_state with the JAX names: the codec computes in bf16
    on f32 trainable leaves, frozen leaves stored in bf16, Adam's mu in
    bf16; a feat step leaves the frozen leaves bit-unchanged and moves the
    trainable ones; save and load keep every dtype; the deploy export is
    f32 and loads back into bf16 storage exactly."""
    from sic_tpu_torch.train import (MomentDtypeAdam, is_frozen_path,
                                     load_checkpoint, named_codec_params,
                                     save_checkpoint)
    from sic_tpu_torch.weights import load_flax_params
    model, state, steps = _tiny_state(dtype=BF16, mu_dtype=BF16,
                                      frozen_dtype=BF16, donate=True)
    assert isinstance(state.opt_ae, MomentDtypeAdam)
    assert model.prior_fusion.ffn_fc2.compute_dtype == BF16
    before = export_flax_params(model)
    for path, p in named_codec_params(model):
        assert p.dtype == (BF16 if is_frozen_path(path) else torch.float32), path
    x = torch.from_numpy(np.clip(_x((1, 256, 256, 3), 31, 0.5), -1, 1))
    logs = steps.feat_step(state, x)
    assert all(torch.isfinite(v).all() for v in logs.values())
    after = export_flax_params(model)
    moved = [k for k in after if not np.array_equal(after[k], before[k])]
    assert moved and all(not is_frozen_path(tuple(k.split("/"))) for k in moved)
    assert all(v.dtype == np.float32 for v in after.values())
    path = save_checkpoint(tmp_path, state, "last")
    _, state2, _ = _tiny_state(dtype=BF16, mu_dtype=BF16, frozen_dtype=BF16)
    load_checkpoint(path, state2)
    assert state2.opt_ae.state and \
        all(s["exp_avg"].dtype == BF16 for s in state2.opt_ae.state.values())
    for a, b in zip(model.parameters(), state2.model.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, state3, _ = _tiny_state(frozen_dtype=BF16)
    assert not load_flax_params(state3.model, after)
    for a, b in zip(model.parameters(), state3.model.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- TensorBoard files ------------------------------------------------------------


def test_tb_writer_files_read_by_the_jax_reader(tmp_path):
    from sic_tpu.utils.tb_writer import read_events
    from sic_tpu_torch.utils.tb_writer import MetricsWriter
    with MetricsWriter(tmp_path) as w:
        log = w.as_log_fn()
        log({"train/loss": 0.5, "stage": "feat", "step": 3})
        log({"train/loss": 0.25, "train/bpp": 0.125})
        w.image("val/recon", np.zeros((4, 4, 3), np.float32), step=4)
    (events,) = tmp_path.glob("events.out.tfevents.*")
    got = [(e["step"], v["tag"], v.get("simple_value"))
           for e in read_events(events) for v in e.get("values", [])]
    assert got == [(3, "train/loss", 0.5), (3, "step", 3.0),
                   (4, "train/loss", 0.25), (4, "train/bpp", 0.125),
                   (4, "val/recon", None)]
    import json
    lines = [json.loads(s) for s in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert lines[0] == {"tag": "train/loss", "value": 0.5, "step": 3}


# -- the train CLI ------------------------------------------------------------------


@pytest.mark.parametrize("device,f32_frozen,want", [
    ("cpu", False, (None, None)), ("cpu", True, (None, None)),
    ("cuda", False, (BF16, BF16)), (None, False, (BF16, BF16)),
    ("cuda:1", True, (BF16, None))])
def test_train_cli_accelerator_rule(device, f32_frozen, want):
    """The JAX CLI's rule, on_tpu = platform != "cpu": bf16 moments and
    bf16 frozen storage on an accelerator (CUDA, the default device)."""
    from sic_tpu_torch.cli.train import accelerator_dtypes
    assert accelerator_dtypes(device, f32_frozen) == want


@pytest.fixture(scope="module")
def two_images(tmp_path_factory):
    import shutil
    d = tmp_path_factory.mktemp("imgs")
    for i in (1, 2):
        shutil.copy(ROOT / "artifacts_r05" / "heldout" / f"val{i}.png", d)
    return d


def test_train_cli_log_dir_and_flags(two_images, tmp_path):
    """A YAML with save_mem: True trains with remat; --log_dir writes an
    event file and scalars.jsonl of the step logs; --no_donate and
    --f32_frozen are taken (on the CPU the frozen leaves are f32 either
    way)."""
    from sic_tpu.utils.tb_writer import read_events
    from sic_tpu_torch.cli.train import main as train_main
    remat = tmp_path / "remat.yaml"
    remat.write_text(TINY_YAML.read_text().replace(
        "    n_attn: 1\n", "    n_attn: 1\n    save_mem: True\n"))
    out = train_main(["--base_config", str(remat), "--device", "cpu",
                      "--train_dir", str(two_images), "--batch_size", "2",
                      "--perceptual", "msssim", "--epochs", "1", "--ckpt_dir",
                      str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs"),
                      "--no_donate", "--f32_frozen"])
    assert out["global_step"] == 1 and out["remat"] is True
    assert out["mu_dtype"] == out["frozen_dtype"] == "None"
    (events,) = (tmp_path / "logs").glob("events.out.tfevents.*")
    tags = {v["tag"] for e in read_events(events) for v in e.get("values", [])}
    assert {"train/align_loss", "train/bpp", "epoch_s"} <= tags
    assert (tmp_path / "logs" / "scalars.jsonl").stat().st_size > 0


# -- checkpoint interop -------------------------------------------------------------


def test_converter_golden_params_decode_in_the_port(tmp_path):
    """The golden params saved by the JAX package (orbax), converted to the
    port's npz, decode golden.c2df in the port within the golden bound."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    from convert_params import main as convert
    from PIL import Image

    from sic_tpu.checkpoint import save_codec_params
    from sic_tpu_torch.cli.decompress import main as decompress
    from test_torch_codec import _golden_bound
    with np.load(GOLDEN / "params.npz") as z:
        flat = {k: z[k] for k in z.files}
    save_codec_params(tmp_path / "orbax", unflatten_dict(flat, sep="/"))
    assert convert(["to-npz", str(tmp_path / "orbax"), str(tmp_path / "p.npz"),
                    "--spec", "tiny"]) == 0
    with np.load(tmp_path / "p.npz") as z:
        assert set(z.files) == set(flat)
        assert all(z[k].dtype == np.float32 for k in z.files)
    src = tmp_path / "in"
    src.mkdir()
    (src / "golden.c2df").write_bytes((GOLDEN / "golden.c2df").read_bytes())
    assert decompress(["--dataset_dir", str(src), "--save_dir", str(tmp_path / "out"),
                       "--spec", "tiny", "--device", "cpu",
                       "--ckpt_path", str(tmp_path / "p.npz")]) == 1
    got = np.asarray(Image.open(tmp_path / "out" / "golden.png"))
    _golden_bound(got, np.load(GOLDEN / "expected_u8.npz")["u8"])


def test_converter_port_deploy_params_restore_in_jax(tmp_path):
    """A port deploy npz after one tiny bf16-storage training step (frozen
    leaves in bf16, exported upcast), converted to orbax, restored by
    load_codec_params leaf for leaf."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    from convert_params import main as convert

    from sic_tpu.checkpoint import load_codec_params
    from sic_tpu.config import tiny_spec as jtiny
    model, state, steps = _tiny_state(mu_dtype=BF16, frozen_dtype=BF16)
    steps.feat_step(state, torch.from_numpy(np.clip(_x((1, 256, 256, 3), 32), -1, 1)))
    flat = export_flax_params(model)
    np.savez(tmp_path / "deploy_params.npz", **flat)
    assert convert(["to-orbax", str(tmp_path / "deploy_params.npz"),
                    str(tmp_path / "orbax")]) == 0
    got = flatten_dict(load_codec_params(tmp_path / "orbax", jtiny()), sep="/")
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


# -- the reference's CLI flags and the runtime's timer ---------------------------------


def test_reference_command_lines_run_through_both_clis(two_images, tmp_path, monkeypatch):
    """--gpu_idx 0, --bpe_path and --stream_part 2 as the reference's
    scripts pass them (with --device cpu, which wins over --gpu_idx); the
    streams carry 2 parts and decode; without --stream_part,
    SIC_STREAM_PART sets the runtime's part count."""
    from sic_tpu_torch.cli._common import cli_device, load_runtime
    from sic_tpu_torch.cli.compress import main as compress
    from sic_tpu_torch.cli.decompress import main as decompress
    import gzip

    from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
    from sic_tpu_torch.ops import split_substreams
    bpe = tmp_path / "merges.txt.gz"
    with gzip.open(bpe, "wt") as f:
        f.write("#version: 0.2\nh e\n")
    common = ["--spec", "tiny", "--device", "cpu", "--gpu_idx", "0"]
    res = compress(["--dataset_dir", str(two_images), "--save_dir", str(tmp_path / "c"),
                    "--bpe_path", str(bpe), "--stream_part", "2", *common])
    assert res["images"] == 2
    for f in sorted((tmp_path / "c" / "bitstreams").glob("*.c2df")):
        enc, _ = unpack_c2df(f)
        assert len(split_substreams(sanitize_enc_result_types(enc)["h_bit_stream"])) == 2
    assert decompress(["--dataset_dir", str(tmp_path / "c" / "bitstreams"),
                       "--save_dir", str(tmp_path / "d"), "--stream_part", "2",
                       *common]) == 2
    ns = __import__("argparse").Namespace
    assert cli_device(ns(device=None, gpu_idx=1)) == "cuda:1"
    assert cli_device(ns(device="cpu", gpu_idx=1)) == "cpu"
    assert cli_device(ns(device=None, gpu_idx=None)) is None
    monkeypatch.setenv("SIC_STREAM_PART", "3")
    rt = load_runtime(None, tcfg.tiny_spec(), device="cpu")
    rt.close()
    assert rt.stream_part == 3
    rt = load_runtime(None, tcfg.tiny_spec(), device="cpu", stream_part=1)
    rt.close()
    assert rt.stream_part == 1


def test_profile_trace_writes_a_trace_with_the_stages(tmp_path):
    """profile_trace writes a trace TensorBoard's profiler plugin opens
    (``*.pt.trace.json``), holding timed_stage's annotations by name."""
    import json

    from sic_tpu_torch.utils.profiling import StageTimer, profile_trace, timed_stage
    timer = StageTimer()
    with profile_trace(tmp_path):
        with timed_stage(timer, "h_rans"):
            torch.ones(64).cumsum(0)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "h_rans" in names and set(timer.stages) == {"h_rans"}
