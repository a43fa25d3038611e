"""The port's GPipe pipeline over processes, and the trunk layouts, against
the JAX package and against the sequential trunks, on the CPU over gloo.

- ``cell_partition`` and ``cell_gates`` equal the JAX functions on the
  shipped geometries, the tiny test geometry, and raise where they raise.
- ``stack_trunk``, ``stack_hybrid_cells``, ``unstack_hybrid_cells``,
  ``codec_params_stack`` and ``codec_params_canonicalize`` over the port's
  flat ``params/...`` dicts equal the JAX functions over the same numpy
  params, exactly (an insert-free cell's zeroed leaves included).
- The tiny codec with two trunk cells a side as two pipeline stages at 2
  and 4 microbatches: the loss and the reconstruction within 1e-5, every
  gradient (each stage's own trunk leaves, the replicated leaves on both
  ranks) within 1e-4 of its norm past ``PERF.md`` §2's floor, against the
  sequential codec; each stage holds only its own cells.
- ``pipeline_vit_trunk`` over a tiny TiTok encoder trunk equals the JAX
  ``pipeline_vit_trunk`` on two of the conftest's 8 CPU devices.
- ``train --pp 2`` on two ranks writes a named-layout
  ``deploy_params.npz`` that the compress and decompress CLIs load (the
  stream decodes to its encoder's y_hat exactly) and a ``last`` that loads
  into a one-process state.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp

import _torch_dist_workers as W
from sic_tpu_torch import config as tcfg
from sic_tpu_torch.weights import export_flax_params
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY_CFG = str(REPO / "tests" / "fixtures" / "config_tiny.yaml")
TOL = 1e-5


@pytest.mark.parametrize("L,ipos", [(24, (3, 7, 11, 15, 19)), (8, (1, 3, 5, 7)),
                                    (2, (0, 1)), (2, (0,)), (2, (3, 7)),
                                    (0, ())],
                         ids=["flagship", "small", "tiny_pp", "insert_free",
                              "no_live", "raises"])
def test_cell_partition_and_gates_match_jax(L, ipos):
    from sic_tpu.models.hybrid import cell_gates as jgates
    from sic_tpu.models.hybrid import cell_partition as jpart
    from sic_tpu_torch.models.hybrid import cell_gates, cell_partition
    try:
        want = (jpart(L, ipos), jgates(L, ipos))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            cell_partition(L, ipos)
        with pytest.raises(ValueError):
            cell_gates(L, ipos)
        return
    assert (cell_partition(L, ipos), cell_gates(L, ipos)) == want


# -- layouts -------------------------------------------------------------------

# encoder with an insert-free second cell (zeroed interaction leaves),
# decoder with both cells gated on
LAYOUT_SPEC = dict(insert_pos_enc=(0,), insert_pos_dec=(0, 1))


@pytest.fixture(scope="module")
def named_params():
    return export_flax_params(W.pp_codec(spec=tcfg.tiny_spec(**LAYOUT_SPEC)))


def _jax_flat(tree, prefix=""):
    return {prefix + k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:4]
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def _side(flat, side):
    pre = f"params/hybrid_codec/{side}/"
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_trunk_layouts_match_jax(named_params, side):
    from sic_tpu.parallel import pipeline as jp
    from sic_tpu_torch.parallel import pipeline as tp
    spec = tcfg.tiny_spec(**LAYOUT_SPEC)
    ipos = getattr(spec, f"insert_pos_{side[:3]}")
    sub = _side(named_params, side)
    tree = unflatten_dict(sub, sep="/")
    got, n = tp.stack_trunk(sub)
    want, jn = jp.stack_trunk(tree)
    assert n == jn == 2
    _equal(got, _jax_flat(want))
    stacked = tp.stack_hybrid_cells(sub, 2, ipos)
    _equal(stacked, _jax_flat(jp.stack_hybrid_cells(tree, 2, ipos)))
    _equal(tp.unstack_hybrid_cells(stacked, 2, ipos), sub)
    back = jp.unstack_hybrid_cells(unflatten_dict(stacked, sep="/"), 2, ipos)
    _equal(tp.unstack_hybrid_cells(stacked, 2, ipos), _jax_flat(back))


def test_codec_layouts_match_jax(named_params):
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.parallel import codec_params_canonicalize as jcanon
    from sic_tpu.parallel import codec_params_stack as jstack
    from sic_tpu_torch.parallel import (codec_params_canonicalize,
                                        codec_params_stack)
    spec, jspec = tcfg.tiny_spec(**LAYOUT_SPEC), jtiny(**LAYOUT_SPEC)
    tree = unflatten_dict(named_params, sep="/")
    stacked = codec_params_stack(named_params, spec)
    assert any("/encoder/trunk_cells/" in k for k in stacked)
    _equal(stacked, _jax_flat(jstack(tree, jspec)))
    _equal(codec_params_stack(stacked, spec), stacked)          # no-op
    back = codec_params_canonicalize(stacked, spec)
    _equal(back, named_params)
    _equal(back, _jax_flat(jcanon(unflatten_dict(stacked, sep="/"), jspec)))
    _equal(codec_params_canonicalize(named_params, spec), named_params)


# -- the pipeline op -------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    return W.run_task("pipeline", tmp_path_factory.mktemp("pp"))


@pytest.fixture(scope="module")
def sequential():
    x = W.global_batch(4, seed=11)
    return W.codec_grads(W.pp_codec(), x, W.pp_noise(x))


@pytest.mark.parametrize("m", [2, 4])
def test_two_stage_pipeline_equals_the_sequential_trunks(pipeline_runs, sequential, m):
    from sic_tpu_torch.parallel import bubble_fraction
    loss, x_hat, grads = sequential
    trunk = ("/transformer_", "/inter_blocks_", "/feat_blocks_")
    own = []
    for res in pipeline_runs:
        l, xh, g = res[f"codec_m{m}"]
        assert abs(l - loss) <= TOL * abs(loss)
        assert float((xh - x_hat).abs().max()) <= TOL * float(x_hat.abs().max())
        err, key = W.worst_leaf(g, {k: grads[k] for k in g})
        assert err <= 1e-4, (key, err)
        own.append({k for k in g if any(t in k for t in trunk)})
    # each stage holds its own cell (layer, cross block, refiner) a side,
    # together every trunk leaf once; the replicated leaves on both
    assert own[0] and own[1] and not own[0] & own[1]
    assert own[0] | own[1] == {k for k in grads if any(t in k for t in trunk)}
    assert all("_0/" in k for k in own[0]) and all("_1/" in k for k in own[1])
    rep = set(pipeline_runs[0][f"codec_m{m}"][2]) - own[0]
    assert rep == set(pipeline_runs[1][f"codec_m{m}"][2]) - own[1]
    assert bubble_fraction(2, m) == 1 / (1 + m)


def test_one_stage_pipeline_is_the_sequential_forward(sequential):
    """PPConfig without a group: one stage in this process, microbatched."""
    from sic_tpu_torch.models.hybrid import PPConfig
    x = W.global_batch(4, seed=11)
    loss, x_hat, grads = W.codec_grads(W.pp_codec(PPConfig(None, 2)), x,
                                       W.pp_noise(x))
    assert abs(loss - sequential[0]) <= TOL * abs(loss)
    err, key = W.worst_leaf(grads, sequential[2])
    assert err <= 1e-4, (key, err)


def test_pipeline_vit_trunk_matches_jax(pipeline_runs):
    from sic_tpu.parallel import make_mesh, pipeline_vit_trunk
    enc, x = W.vit_trunk()
    params = unflatten_dict(export_flax_params(enc), sep="/")["params"]
    mesh = make_mesh(shape=(2,), axis_names=("pipe",), devices=jax.devices()[:2])
    want = np.asarray(pipeline_vit_trunk(params, enc.spec.num_heads,
                                         jnp.asarray(x), mesh, n_microbatch=2))
    for res in pipeline_runs:
        got = res["vit"].numpy()
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# -- the train CLI under --pp ------------------------------------------------------

def test_pp_train_cli_writes_named_deploy_params(tmp_path):
    from PIL import Image
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.cli.compress import main as compress_main
    from sic_tpu_torch.cli.decompress import main as decompress_main
    from sic_tpu_torch.config import load_config
    from sic_tpu_torch.train import load_checkpoint
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(7)
    for i in range(3):
        arr = (rng.uniform(size=(256, 264 + 8 * i, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(imgs / f"img_{i}.png")
    ck = tmp_path / "ck"
    # both stages take one batch sequence (the last stage's loss reads its
    # own x); the partial second batch is dropped
    res = W.run_train_cli(tmp_path, ["--base_config", TINY_CFG, "--device", "cpu",
                                     "--epochs", "1", "--train_dir", str(imgs),
                                     "--batch_size", "2", "--pp", "2",
                                     "--perceptual", "msssim", "--ckpt_dir", str(ck)])
    assert "pipeline parallel: 2 stages x 1 data, 2 cells" in res[0][2]
    deploy = ck / "deploy_params.npz"
    spec = load_config(TINY_CFG).spec
    with np.load(deploy) as z:
        keys = set(z.files)
    assert not any("trunk_cells" in k for k in keys)
    for side in ("encoder", "decoder"):
        for i in (0, 1):
            assert f"params/hybrid_codec/{side}/transformer_{i}/ln_1/scale" in keys
        assert any(k.startswith(f"params/hybrid_codec/{side}/inter_blocks_0/") for k in keys)
    # the deploy CLIs load it; a stream decodes to its encoder's y_hat
    out = tmp_path / "out"
    compress_main(["--base_config", TINY_CFG, "--ckpt_path", str(deploy),
                   "--device", "cpu", "--dataset_dir", str(imgs),
                   "--save_dir", str(out)])
    decompress_main(["--base_config", TINY_CFG, "--ckpt_path", str(deploy),
                     "--device", "cpu", "--dataset_dir", str(out / "bitstreams"),
                     "--save_dir", str(tmp_path / "png")])
    assert len(list((tmp_path / "png").glob("*.png"))) == 3
    rt = load_runtime(str(deploy), spec, device="cpu")
    x = torch.rand(1, 256, 256, 3) * 2 - 1
    enc_probe, dec_probe = {}, {}
    enc = rt.encode_only(x, probe=enc_probe)
    rt.decode_only(**enc, probe=dec_probe)
    assert torch.equal(dec_probe["h_hat"], enc_probe["y_hat"])
    rt.close()
    # `last` holds the whole model, in the one-process layout
    _, state, _ = W.train_state(spec=spec)
    load_checkpoint(ck / "last", state)
    assert state.global_step == 1
    full = export_flax_params(state.model)
    with np.load(deploy) as z:
        for k in full:
            np.testing.assert_array_equal(z[k], full[k], err_msg=k)
