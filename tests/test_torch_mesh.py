"""The port's process-grid shardings (``parallel/mesh.py``) on the CPU,
over gloo, against the JAX package's mesh shardings and against the
port's own one-process runs.

- Plans: on the tiny codec's whole tree, ``tp_plan`` and ``fsdp_plan``
  split the leaves ``tp_sharding`` and ``fsdp_sharding`` split, on the same
  (transposed) dimension, with and without ``fsdp_axis``; the one
  deviation is a block whose head count does not divide by ``tp`` (one
  64-wide head), which the port keeps whole.  The JAX tests' own cases
  (``test_tp_sharding_specs``, ``test_fsdp_sharding_specs``) are ported.
- TP: the golden tiny codec's forward at ``--tp 2`` matches the JAX package's
  ``shard_state_tp`` forward on its (2, 2, 2) mesh (x_hat within 2e-4,
  bpp within 2e-5: ``tests/test_parallel.py``'s bounds); the feat and pix
  steps match the one-process step (losses within 1e-4 / 1e-3, each leaf's
  gradient within 1e-3 / 5e-3 of its norm), and the unsplit leaves are
  equal on both ranks.  Adding the row-parallel bias on every rank (the
  negative control) breaks the forward's bound.
- Tile: at ``--tile 2`` on a two-tile-wide image and on the one-tile
  crop, the forward and both steps match the one-process ones within the
  same bounds; a local ``torch.roll``, a local shift mask or local
  GroupNorm statistics on the slabs break them.
- FSDP at world size 2 equals the data-parallel step leaf for leaf
  (gradients, parameters and both Adam moments), holds at most half of
  each planned leaf plus the unplanned ones between steps, and its
  checkpoint (one-process layout) reads back into a sharded state;
  ``--pp 2 --fsdp`` at world size 4 equals ``--pp 2`` within the pipeline
  test's bound.
- ``CodecRuntime(mesh=)`` at data 1 x tile 2 and data 2 x tile 1: every
  rank gets the same streams, they decode in a one-process runtime to the
  mesh runtime's y_hat exactly, and the mesh runtime's own decode equals
  the one-process decode's pixels within 2e-4; at data 2, a batch that
  does not split over the data ranks (one stream, three streams) decodes
  to the pixels of a one-process runtime in the same rank, bit for bit.
"""
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
import _torch_mesh_workers as M
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

LIMITS = {"feat": (1e-4, 1e-3), "pix": (1e-3, 5e-3)}


# -- plans against the JAX package ------------------------------------------------

def _jax_specs(tree_specs):
    import jax
    from sic_tpu.parallel.mesh import _path_str
    flat = jax.tree_util.tree_flatten_with_path(
        tree_specs, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {_path_str(p)[1:]: tuple(s.spec) for p, s in flat}


@pytest.fixture(scope="module")
def tiny_trees():
    """(port codec, JAX params tree of the same leaves and shapes)."""
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    from sic_tpu_torch.weights import export_flax_params
    model = M.seeded_codec()
    flat = export_flax_params(model)
    tree = unflatten_dict({tuple(k.split("/")): jnp.zeros(v.shape, jnp.float32)
                           for k, v in flat.items()})
    return model, tree


def _want(spec, dims, axis):
    spec = list(spec) + [None] * (len(dims) - len(spec))
    hit = [dims[i] for i, s in enumerate(spec) if s == axis]
    return hit[0] if hit else None


def _one_head_blocks(model, n):
    """Torch-layout leaves of the attention blocks whose heads do not
    divide by ``n`` (the port keeps them whole; JAX splits the packed
    dimension)."""
    from sic_tpu_torch.models.layers import MultiheadSelfAttention
    from sic_tpu_torch.models.swin import WindowAttention
    from sic_tpu_torch.weights import flax_key
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (MultiheadSelfAttention, WindowAttention)):
            heads = mod.num_heads if isinstance(mod, MultiheadSelfAttention) else mod.heads
            if heads % n:
                for lin in ("in_proj", "out_proj", "to_qkv", "to_out"):
                    if hasattr(mod, lin):
                        sub = getattr(mod, lin)
                        for leaf, _ in sub.named_parameters():
                            out.add(flax_key(f"{name}.{lin}.{leaf}", sub))
    return out


@pytest.mark.parametrize("fsdp_axis", [None, "data"])
def test_tp_plan_matches_tp_sharding(tiny_trees, fsdp_axis):
    from sic_tpu.parallel import make_mesh as jax_mesh
    from sic_tpu.parallel import tp_sharding
    from sic_tpu_torch.parallel import tp_plan
    from sic_tpu_torch.parallel.mesh import _flax_dims, named_leaves
    model, tree = tiny_trees
    mesh = jax_mesh(shape=(2, 2, 2), axis_names=("data", "model", "tile"))
    want = _jax_specs(tp_sharding(tree, mesh, fsdp_axis=fsdp_axis))
    got = tp_plan(model, 2, 2 if fsdp_axis else 1)
    dims = {k: _flax_dims(mod, leaf, p.ndim) for k, _, mod, leaf, p in named_leaves(model)}
    assert set(got) == set(want)
    deviating = _one_head_blocks(model, 2)
    assert deviating            # the tiny codec's 64-wide Swin blocks
    split = 0
    for k, spec in want.items():
        w = (_want(spec, dims[k], "model"), _want(spec, dims[k], "data"))
        if k in deviating and w[0] is not None:
            assert got[k][0] is None, k
            continue
        assert got[k] == w, (k, got[k], w)
        split += w[0] is not None
    assert split > 20


def test_fsdp_plan_matches_fsdp_sharding(tiny_trees):
    from sic_tpu.parallel import fsdp_sharding
    from sic_tpu.parallel import make_mesh as jax_mesh
    from sic_tpu_torch.parallel import fsdp_plan
    from sic_tpu_torch.parallel.mesh import _flax_dims, named_leaves
    model, tree = tiny_trees
    mesh = jax_mesh(shape=(2, 2, 2), axis_names=("data", "model", "tile"))
    want = _jax_specs(fsdp_sharding(tree, mesh))
    got = fsdp_plan(model, 2)
    dims = {k: _flax_dims(mod, leaf, p.ndim) for k, _, mod, leaf, p in named_leaves(model)}
    assert set(got) == set(want)
    assert {k: _want(s, dims[k], "data") for k, s in want.items()} == got
    assert sum(d is not None for d in got.values()) > 10


# the leaves of tests/test_parallel.py::test_fsdp_sharding_specs, in the
# JAX layout (the port's rule sees them untransposed)
FSDP_CASES = {"big": (8, 128, 128), "odd": (7, 129 * 1024), "small": (4,),
              "scalar": ()}


@pytest.mark.parametrize("leaf", sorted(FSDP_CASES))
def test_fsdp_rule_cases_of_jax(leaf):
    import jax.numpy as jnp
    from sic_tpu.parallel import fsdp_sharding
    from sic_tpu.parallel import make_mesh as jax_mesh
    from sic_tpu_torch.parallel.mesh import _fsdp_dim
    shape = FSDP_CASES[leaf]
    spec = tuple(fsdp_sharding({"x": jnp.zeros(shape)}, jax_mesh(shape=(4, 2)),
                               min_size=1 << 10)["x"].spec)
    got = _fsdp_dim(shape, list(range(len(shape))), 4, 1 << 10)
    assert got == _want(spec, list(range(len(shape))), "data")


def _tp_case_model():
    """test_tp_sharding_specs's tree as port modules: an attention block
    (8 wide, 2 heads: in_proj (24, 8)), an MLP (8 -> 32), a window
    attention (to_qkv (24, 8)) in a Swin block whose MLP is 33 wide (not
    divisible), and a convolution (no rule)."""
    from torch import nn
    from sic_tpu_torch.models.layers import MLP, Conv2d, MultiheadSelfAttention
    from sic_tpu_torch.models.swin import SwinBlock

    class Tree(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = MultiheadSelfAttention(8, 2)
            self.mlp = MLP(8, 32)
            self.swin = SwinBlock(8, 2, 4, 33, 2, False, False)
            self.conv = Conv2d(8, 16, 3)
    return Tree()


TP_CASES = [("params/attn/in_proj/kernel", (0, None), (0, 1)),
            ("params/attn/in_proj/bias", (0, None), (0, None)),
            ("params/attn/out_proj/kernel", (1, None), (1, 0)),
            ("params/attn/out_proj/bias", (None, None), (None, 0)),
            ("params/mlp/c_fc/kernel", (0, None), (0, 1)),
            ("params/swin/attention_block/to_qkv/kernel", (0, None), (0, 1)),
            ("params/swin/mlp_fc2/kernel", (None, None), (None, 0)),
            ("params/conv/kernel", (None, None), (None, 0))]


@pytest.mark.parametrize("key,plain,with_fsdp", TP_CASES,
                         ids=[c[0].split("/", 1)[1] for c in TP_CASES])
def test_tp_rule_cases_of_jax(key, plain, with_fsdp):
    """``test_tp_sharding_specs``'s cases: column-parallel qkv and MLP-up
    weights, row-parallel out and MLP-down weights with a whole bias, a
    non-divisible MLP and a convolution unsplit; with ``fsdp_axis`` (min
    size 1) a split leaf also splits its free dimension over data and the
    rest take the FSDP rule."""
    from sic_tpu_torch.parallel import tp_plan
    model = _tp_case_model()
    assert tp_plan(model, 2)[key] == plain
    assert tp_plan(model, 2, 2, min_size=1)[key] == with_fsdp


# -- tensor parallelism -------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    return M.run_task("tp", tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def one_process():
    """The one-process forwards (golden parameters) and the feat and pix
    steps, from the same parameters and seeds as the ranks'."""
    model = M.seeded_codec(golden=True)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    other = {"fwd_wide1": M.forward(model, M.wide_x(1)),
             "fwd_crop": M.forward(model, M.crop_x())}
    torch.set_num_threads(n)
    return {"fwd_golden": M.forward(model, M.wide_x()),
            "fwd_wide1": M.forward(model, M.wide_x(1)),
            "fwd_crop": M.forward(model, M.crop_x()),
            "threads4": other,
            "steps_crop": M.steps(None, M.crop_x()),
            "steps_wide": M.steps(None, M.wide_x(1))}


@pytest.fixture(scope="module")
def jax_tp_forward():
    """The JAX package's tiny codec forward under ``shard_state_tp`` on its
    (2, 2, 2) mesh, with the golden parameters.  (With the seeded ones the
    two packages' one-process forwards already differ by 3.4e-4 on this
    image, more than the bound: their activations run into the thousands;
    the golden parameters' differ by 8.7e-5.)"""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    from sic_tpu.config import tiny_spec
    from sic_tpu.models import Codec
    from sic_tpu.parallel import make_mesh as jax_mesh
    from sic_tpu.parallel import shard_batch, shard_state_tp
    from sic_tpu_torch.weights import export_flax_params
    flat = export_flax_params(M.seeded_codec(golden=True))
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    model = Codec(tiny_spec())

    @jax.jit
    def fwd(p, x):
        out = model.apply(p, x, need_full_decode=True)
        return out["x_hat"], out["bpp_loss"]

    mesh = jax_mesh(shape=(2, 2, 2), axis_names=("data", "model", "tile"))
    xh, bpp = fwd(shard_state_tp(params, mesh), shard_batch(jnp.asarray(M.wide_x()), mesh))
    return np.asarray(xh), float(bpp)


def _forward_err(got, want):
    return (float((got[0] - torch.as_tensor(np.asarray(want[0]))).abs().max()),
            abs(got[1] - want[1]))


def test_tp_forward_matches_jax_tp(tp_runs, jax_tp_forward, one_process):
    """Against the port's one-process forward within the JAX test's bounds;
    against the JAX ``shard_state_tp`` forward within those bounds or 1.5x
    the port's one-process gap to it, whichever is larger: with one
    intra-op thread the port's CPU convolutions already differ from XLA's
    by 2.3e-4 on this image (7.6e-5 with four threads), split or not."""
    floor = _forward_err(one_process["fwd_golden"], jax_tp_forward)
    for r in tp_runs:
        xh_err, bpp_err = _forward_err(r["fwd"], one_process["fwd_golden"])
        assert xh_err <= 2e-4 and bpp_err <= 2e-5, (xh_err, bpp_err)
        xh_err, bpp_err = _forward_err(r["fwd"], jax_tp_forward)
        assert xh_err <= max(2e-4, 1.5 * floor[0]), (xh_err, floor)
        assert bpp_err <= max(2e-5, 1.5 * floor[1]), (bpp_err, floor)


def test_tp_row_bias_once_and_on_every_rank(tp_runs):
    """With nonzero row-parallel biases the split forward matches the
    one-process one; adding them on every rank (before the all-reduce)
    fails the bound."""
    want = M.forward(M.with_row_biases(M.seeded_codec(golden=True)), M.wide_x())
    for r in tp_runs:
        xh_err, bpp_err = _forward_err(r["fwd_biased"], want)
        assert xh_err <= 2e-4 and bpp_err <= 2e-5, (xh_err, bpp_err)
    xh_err, _ = _forward_err(tp_runs[0]["fwd_bias_every_rank"], want)
    assert xh_err > 2e-4 * 10, xh_err


def _check_steps(got, want, stage, logs_rel=None):
    log_tol, leaf_tol = LIMITS[stage]
    for k, v in want["logs"].items():
        assert abs(got["logs"][k] - v) <= (logs_rel or log_tol) * max(abs(v), 1e-6), \
            (stage, k, got["logs"][k], v)
    err, key = W.worst_leaf(got["grads"], want["grads"])
    assert err <= leaf_tol, (stage, key, err)
    return err


@pytest.mark.parametrize("stage", ["feat", "pix"])
def test_tp_steps_match_one_process(tp_runs, one_process, stage):
    want = one_process["steps_crop"][stage]
    for r in tp_runs:
        _check_steps(r["steps"][stage], want, stage)
    # the leaves no rank splits hold one gradient on both ranks
    a, b = (r["steps"][stage]["local"] for r in tp_runs)
    whole = [k for k in a if a[k].shape == want["grads"][k].shape]
    assert len(whole) > 100
    assert all(torch.equal(a[k], b[k]) for k in whole)
    split = [k for k in a if a[k].shape != want["grads"][k].shape]
    assert split and all(a[k].numel() * 2 == want["grads"][k].numel() for k in split)


# -- the width split -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tile_runs(tmp_path_factory):
    return M.run_task("tile", tmp_path_factory.mktemp("tile"))


@pytest.mark.parametrize("which", ["wide", "crop"])
def test_tile_forward_matches_one_process(tile_runs, one_process, which):
    """Within the JAX test's bounds, or 1.5x the one-process forward's own
    change from one to four intra-op threads (the convolution library's
    other blocking, which a slab's other width also brings), whichever is
    larger."""
    key = "fwd_wide1" if which == "wide" else "fwd_crop"
    want = one_process[key]
    floor = _forward_err(one_process["threads4"][key], want)
    for r in tile_runs:
        xh_err, bpp_err = _forward_err(r[f"fwd_{which}_tile"], want)
        assert xh_err <= max(2e-4, 1.5 * floor[0]), (xh_err, floor)
        assert bpp_err <= max(2e-5, 1.5 * floor[1]), (bpp_err, floor)


@pytest.mark.parametrize("control", ["roll", "mask", "groupnorm"])
def test_tile_negative_controls_fail_the_bound(tile_runs, one_process, control):
    xh_err, _ = _forward_err(tile_runs[0][f"ctl_{control}"], one_process["fwd_wide1"])
    assert xh_err > 2e-4 * 10, (control, xh_err)


@pytest.mark.parametrize("which", ["wide", "crop"])
@pytest.mark.parametrize("stage", ["feat", "pix"])
def test_tile_steps_match_one_process(tile_runs, one_process, which, stage):
    want = one_process[f"steps_{which}"][stage]
    for r in tile_runs:
        _check_steps(r[f"steps_{which}"][stage], want, stage)
    a, b = (r[f"steps_{which}"][stage] for r in tile_runs)
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_tile_perceptual_distance_on_slabs(tile_runs):
    from sic_tpu_torch.models.lpips import LPIPS
    lp = LPIPS()
    lp.init_weights(torch.Generator().manual_seed(1))
    a, b = M.wide_x(1, 5)[:, :64, :128], M.wide_x(1, 6)[:, :64, :128]
    with torch.no_grad():
        want = float(lp(torch.from_numpy(np.ascontiguousarray(a)),
                        torch.from_numpy(np.ascontiguousarray(b)))[0])
    for r in tile_runs:
        assert abs(r["lpips"] - want) <= 1e-5 * abs(want)


# -- FSDP ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    return M.run_task("fsdp", tmp_path_factory.mktemp("fsdp"))


@pytest.mark.parametrize("stage", ["feat", "pix"])
def test_fsdp_step_equals_the_data_parallel_step(fsdp_runs, stage):
    for r in fsdp_runs:
        got, want = r["fsdp"][stage], r["dp"][stage]
        assert got["logs"] == want["logs"]
        for part in ("grads", "params", "mu", "nu"):
            assert set(got[part]) == set(want[part]), part
            bad = [k for k in want[part] if not torch.equal(got[part][k], want[part][k])]
            assert not bad, (part, bad[:3])


def test_fsdp_holds_its_chunks_between_steps(fsdp_runs):
    """A rank's parameters and Adam moments between steps: half of each
    planned leaf (the JAX rule's), every unplanned one whole; the planned
    ones are the codec's and the discriminator's large leaves."""
    from sic_tpu_torch.parallel import fsdp_plan
    model = M.seeded_codec()
    plan = {k for k, d in fsdp_plan(model, 2).items() if d is not None}
    for r in fsdp_runs:
        got, dp = r["fsdp"]["pix"], r["dp"]["pix"]
        assert plan <= got["planned"]
        assert all(k.startswith("disc.") for k in got["planned"] - plan)
        want = sum(t.numel() * 4 // (2 if k in got["planned"] else 1)
                   for part in ("params", "mu", "nu") for k, t in dp[part].items())
        assert got["bytes"] == want, (got["bytes"], want, dp["bytes"])
    assert fsdp_runs[0]["resume_equal"] and fsdp_runs[1]["resume_equal"]
    shapes = fsdp_runs[0]["ck_shapes"]
    for name, p in model.state_dict().items():
        assert shapes[name] == tuple(p.shape), name


def test_pp_fsdp_equals_pp(tmp_path):
    runs = M.run_task("pp_fsdp", tmp_path, world=4)
    got, want = runs[0][True][0], runs[0][False][0]
    assert got["logs"] == pytest.approx(want["logs"], rel=1e-5)
    for k, v in want["model"].items():
        err = float((got["model"][k] - v).abs().max())
        assert err <= 1e-5 * max(float(v.abs().max()), 1e-6), (k, err)
    assert all(r[True][1] < r[False][1] for r in runs)


# -- CodecRuntime(mesh=) ----------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime_runs(tmp_path_factory):
    return M.run_task("runtime", tmp_path_factory.mktemp("runtime"))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["tile2", "data2"])
def test_mesh_runtime_streams_decode_in_one_process(runtime_runs, shape):
    from sic_tpu_torch.models import CodecRuntime
    a, b = (r[shape] for r in runtime_runs)
    assert a["path"] == "host"
    assert [e["h_bit_stream"] for e in a["encs"]] == [e["h_bit_stream"] for e in b["encs"]]
    assert torch.equal(a["y_hat"], b["y_hat"])
    model = M.seeded_codec(golden=True)
    rt = CodecRuntime(model.spec, model, device_entropy="host")
    probe = {}
    x_one = rt.decode_only_batched(a["encs"], probe=probe)
    rt.close()
    assert torch.equal(probe["h_hat"], a["y_hat"])
    assert float((x_one - a["x_hat"]).abs().max()) <= 2e-4


@pytest.mark.parametrize("which", ["one_stream", "three_streams"])
def test_mesh_runtime_decodes_a_batch_that_does_not_split(runtime_runs, which):
    """At data 2, decode_only of one stream and decode_only_batched of
    three run the rows whole on each rank: each rank's pixels equal the
    one-process runtime's in the same process, and the test process's."""
    from sic_tpu_torch.models import CodecRuntime
    encs = runtime_runs[0][(2, 1)]["encs"]
    for r in runtime_runs:
        got, one = r["odd"][which]
        assert torch.equal(got, one)
    assert torch.equal(runtime_runs[0]["odd"][which][0], runtime_runs[1]["odd"][which][0])
    model = M.seeded_codec(golden=True)
    rt = CodecRuntime(model.spec, model, device_entropy="host")
    want = (rt.decode_only(**encs[0]) if which == "one_stream"
            else rt.decode_only_batched([encs[0], encs[1], encs[0]]))
    rt.close()
    got = runtime_runs[0]["odd"][which][0]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2e-4
