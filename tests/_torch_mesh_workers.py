"""Rank processes for the port's mesh tests (CPU, gloo).

    python tests/_torch_mesh_workers.py <task> <out_dir>

with the torchrun variables set (``_torch_dist_workers.run_ranks``).  Each
rank writes ``<out_dir>/<task>_rank<r>.pt``, its tensors on the host, in
the one-process layout where a tensor is split (gathered through the
state's :class:`~sic_tpu_torch.parallel.mesh.Layout`).  No JAX here: the
test files compute the one-process and JAX references.

Tasks:

- ``tp`` (2 ranks, model 2): the golden tiny codec's forward on
  :func:`wide_x`; the same with nonzero row-parallel biases, and with
  those biases added on every rank (the negative control); one feat and one pix step from a fresh seeded state.
- ``tile`` (2 ranks, tile 2): the forward and the feat and pix steps on
  a two-tile-wide image and on the one-tile crop; the forward on the wide
  image with a local ``torch.roll``, a local shift mask and local
  GroupNorm statistics (the negative controls); the perceptual distance on
  slabs.
- ``fsdp`` (2 ranks, data 2): a feat and a pix step under FSDP against
  the data-parallel step, parameters and Adam moments alike, each rank's
  bytes at rest, and a checkpoint written and read back.
- ``pp_fsdp`` (4 ranks, pipe 2 x data 2): a feat step under ``pp`` with
  and without FSDP.
- ``runtime`` (2 ranks): ``CodecRuntime(mesh=)`` encodes at data 1 x
  tile 2 and data 2 x tile 1; at data 2 it also decodes one stream and
  three streams (batches that do not split over the data ranks) beside a
  one-process runtime in the same rank.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

import _torch_dist_workers as W
from sic_tpu_torch import config as tcfg  # noqa: E402

DEVICE = W.DEVICE


def wide_x(n: int = 2, seed: int = 3) -> np.ndarray:
    """(n, 256, 512, 3) in [-1, 1]: two 256-px tiles side by side."""
    return np.random.default_rng(seed).uniform(-1, 1, (n, 256, 512, 3)).astype(np.float32)


def crop_x() -> np.ndarray:
    """The one-tile training crop (2, 256, 256, 3)."""
    return W.global_batch(2)


GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden" / "params.npz"


def seeded_codec(spec=None, golden: bool = False):
    """The tiny codec, seeded, or with the golden (trained) parameters."""
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.weights import init_seeded, load_npz
    with torch.device(DEVICE):
        m = Codec(spec or tcfg.tiny_spec())
    init_seeded(m, 0)
    if golden:
        load_npz(m, GOLDEN)
    return m.eval()


def golden_params() -> dict:
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def mesh_state(mesh, fsdp=False, **kw):
    """A fresh train state of the golden tiny codec (its rate and
    quantizer indices keep their values under the split products' other
    rounding; the seeded codec's activations run into the hundreds, and
    the detail latent's rounding flips)."""
    from sic_tpu_torch.train import ImgLossCfg, create_train_state
    img = ImgLossCfg(perceptual="msssim", **W.DISC)
    return create_train_state(kw.pop("spec", tcfg.tiny_spec()), tcfg.qp_strategy(0),
                              seed=0, img_cfg=img, device=DEVICE, mesh=mesh,
                              fsdp=fsdp, codec_params=golden_params(), **kw)


def whole(state, part: str, name: str, t: torch.Tensor) -> torch.Tensor:
    """The one-process tensor of leaf ``part.name`` (collective)."""
    layout = state.layout
    key = f"{part}.{name}"
    if layout and (key in layout.tp or key in layout.fsdp):
        t = layout.full(key, t)
    return t.detach().cpu()


def step_record(state, logs):
    """Logs; gradients, parameters and Adam moments by JAX key (codec) or
    ``disc.<name>``, whole; and this rank's own (local) gradients."""
    from sic_tpu_torch.weights import flax_key
    mods = dict(state.model.named_modules())
    rec = {"logs": {k: float(v) for k, v in logs.items()}, "grads": {},
           "params": {}, "mu": {}, "nu": {}, "local": {}, "planned": set()}
    parts = [("model", state.model, state.opt_ae), ("disc", state.disc, state.opt_disc)]
    for part, module, opt in parts:
        for name, p in module.named_parameters():
            owner = mods.get(name.rsplit(".", 1)[0]) if part == "model" else None
            key = flax_key(name, owner) if owner is not None else f"{part}.{name}"
            rec["params"][key] = whole(state, part, name, p.data)
            if state.layout and f"{part}.{name}" in state.layout.fsdp:
                rec["planned"].add(key)
            if p.grad is not None:
                rec["grads"][key] = whole(state, part, name, p.grad)
                rec["local"][key] = p.grad.detach().cpu()
            st = opt.state.get(p)
            if st:
                rec["mu"][key] = whole(state, part, name, st["exp_avg"])
                rec["nu"][key] = whole(state, part, name, st["exp_avg_sq"])
    return rec


def local(x, mesh):
    """This rank's part of the host batch ``x``, on the device."""
    from sic_tpu_torch.parallel import shard_batch
    return torch.from_numpy(np.ascontiguousarray(shard_batch(x, mesh))).to(DEVICE)


def steps(mesh, x, fsdp=False, **kw):
    out = {}
    for stage in ("feat", "pix"):
        _, state, st = mesh_state(mesh, fsdp, **kw)
        xl = local(x, mesh)
        logs = (st.feat_step if stage == "feat" else st.pix_step)(state, xl)
        out[stage] = step_record(state, logs)
        out[stage]["bytes"] = state_bytes_of(state)
    return out


def state_bytes_of(state) -> int:
    from sic_tpu_torch.parallel import state_bytes
    return state_bytes([state.model, state.disc], [state.opt_ae, state.opt_disc])


def forward(model, x, mesh=None):
    """x_hat (whole) and bpp of the training forward (no noise)."""
    from sic_tpu_torch.parallel import tile_gather, tile_parallel
    xl = local(x, mesh)
    with torch.no_grad(), tile_parallel(mesh.tile if mesh else None):
        out = model(xl, need_full_decode=True)
        return tile_gather(out["x_hat"]).cpu(), float(out["bpp_loss"])


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def with_row_biases(model):
    """``model`` with seeded nonzero biases on the row-parallel projections
    (the golden and seeded ones are zero), for the bias control."""
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("out_proj.bias", "c_proj.bias", "to_out.bias",
                              "mlp_fc2.bias")):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return model


def tp_task(mesh):
    import torch.nn.functional as F
    from sic_tpu_torch.models import layers
    from sic_tpu_torch.parallel import apply_tp
    res = {}
    model = seeded_codec(golden=True)
    apply_tp(model, mesh.model)
    res["fwd"] = forward(model, wide_x())

    def bias_every_rank(x, w, b, group):
        return layers.reduce_from_model(F.linear(x, w, b), group)

    biased = with_row_biases(seeded_codec(golden=True))
    apply_tp(biased, mesh.model)
    res["fwd_biased"] = forward(biased, wide_x())
    with patched(layers, "_row_parallel", bias_every_rank):
        res["fwd_bias_every_rank"] = forward(biased, wide_x())
    res["steps"] = steps(mesh, crop_x())
    return res


def tile_task(mesh):
    from sic_tpu_torch.models import layers, swin
    from sic_tpu_torch.models.lpips import LPIPS
    from sic_tpu_torch.parallel import tile_parallel
    res = {}
    model = seeded_codec(golden=True)
    res["fwd_wide"] = forward(model, wide_x(1))
    res["fwd_crop"] = forward(model, crop_x())
    res["steps_wide"] = steps(mesh, wide_x(1))
    res["steps_crop"] = steps(mesh, crop_x())

    def local_roll(x, shift, group=None, dim=2):
        return torch.roll(x, shifts=shift, dims=dim)

    with patched(swin, "tile_roll", local_roll):
        res["ctl_roll"] = forward(model, wide_x(1), mesh)
    with patched(swin, "_mask_columns", lambda nww: (0, nww)):
        res["ctl_mask"] = forward(model, wide_x(1), mesh)
    with patched(layers, "_norm_group", lambda: None):
        res["ctl_groupnorm"] = forward(model, wide_x(1), mesh)
    res["fwd_wide_tile"] = forward(model, wide_x(1), mesh)
    res["fwd_crop_tile"] = forward(model, crop_x(), mesh)

    lp = LPIPS().to(DEVICE)
    lp.init_weights(torch.Generator(DEVICE).manual_seed(1))
    a, b = wide_x(1, 5)[:, :64, :128], wide_x(1, 6)[:, :64, :128]
    with torch.no_grad(), tile_parallel(mesh.tile):
        res["lpips"] = float(lp(local(a, mesh), local(b, mesh))[0])
    return res


def fsdp_task(mesh, out_dir):
    from sic_tpu_torch.parallel import make_mesh
    from sic_tpu_torch.train.trainer import load_checkpoint, save_checkpoint
    x = W.global_batch()
    dp = make_mesh((2, 1, 1), ("data", "model", "tile"))
    res = {"fsdp": steps(mesh, x, fsdp=True), "dp": steps(dp, x)}
    # a checkpoint of a sharded state, read back into a fresh one
    _, state, st = mesh_state(mesh, True)
    st.feat_step(state, local(x, mesh))
    path = save_checkpoint(out_dir, state, "fsdp_ck")
    sd = torch.load(path, weights_only=False) if mesh.data.index == 0 else None
    _, fresh, _ = mesh_state(mesh, True)
    load_checkpoint(path, fresh)
    same = all(torch.equal(a, b) for a, b in zip(
        [p.data for p in state.model.parameters()] +
        [t for s in state.opt_ae.state.values() for t in s.values() if t.dim()],
        [p.data for p in fresh.model.parameters()] +
        [t for s in fresh.opt_ae.state.values() for t in s.values() if t.dim()]))
    res["resume_equal"] = same
    if sd is not None:
        res["ck_shapes"] = {k: tuple(v.shape) for k, v in sd["model"].items()}
    return res


def pp_fsdp_task():
    from sic_tpu_torch.models.hybrid import PPConfig
    from sic_tpu_torch.parallel import grid_groups, take_rows
    from sic_tpu_torch.train.trainer import gathered_state_dict
    data, pipe = grid_groups(2)
    x = W.global_batch()
    res = {}
    for fsdp in (False, True):
        _, state, st = W.train_state(data, PPConfig(pipe, 2), tcfg.tiny_spec(**W.PP_SPEC)) \
            if not fsdp else _pp_fsdp_state(data, pipe)
        logs = st.feat_step(state, torch.from_numpy(
            np.ascontiguousarray(take_rows(x, data))).to(DEVICE))
        sd = gathered_state_dict(state)
        res[fsdp] = (None if sd is None else
                     {"logs": {k: float(v) for k, v in logs.items()},
                      "model": {k: v.cpu() for k, v in sd["model"].items()},
                      "opt": sd["opt_ae"]["state"]},
                     state_bytes_of(state))
    return res


def _pp_fsdp_state(data, pipe):
    from sic_tpu_torch.models.hybrid import PPConfig
    from sic_tpu_torch.train import ImgLossCfg, create_train_state
    img = ImgLossCfg(perceptual="msssim", **W.DISC)
    return create_train_state(tcfg.tiny_spec(**W.PP_SPEC), tcfg.qp_strategy(0),
                              seed=0, img_cfg=img, device=DEVICE, data=data,
                              pp=PPConfig(pipe, 2), fsdp=True)


def runtime_task():
    from sic_tpu_torch.models import CodecRuntime
    from sic_tpu_torch.parallel import make_mesh
    res = {}
    model = seeded_codec(golden=True)
    x = wide_x(2, 9)
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "tile"))
        rt = CodecRuntime(model.spec, model, mesh=mesh, device_entropy="host")
        probe = {}
        encs = rt.encode_only_batched(x, probe=probe)
        res[shape] = {"encs": encs, "y_hat": probe["y_hat"].cpu(),
                      "path": probe["h_path"],
                      "x_hat": rt.decode_only_batched(encs).cpu()}
        if shape == (2, 1):
            # batches that do not split over the two data ranks, and the
            # one-process runtime's pixels of the same streams in this rank
            one = CodecRuntime(model.spec, model, device_entropy="host")
            odd = [encs[0], encs[1], encs[0]]
            res["odd"] = {name: (f(rt).cpu(), f(one).cpu()) for name, f in (
                ("one_stream", lambda r: r.decode_only(**encs[0])),
                ("three_streams", lambda r: r.decode_only_batched(odd)))}
            one.close()
        rt.close()
    return res


def main(task: str, out_dir: str) -> None:
    from sic_tpu_torch.parallel import make_mesh, setup_distributed, shutdown
    torch.set_num_threads(1)
    rank, world = setup_distributed(device=DEVICE, placed=DEVICE == "cpu")
    grid = ("data", "model", "tile")
    if task == "tp":
        res = tp_task(make_mesh((1, 2, 1), grid))
    elif task == "tile":
        res = tile_task(make_mesh((1, 1, 2), grid))
    elif task == "fsdp":
        res = fsdp_task(make_mesh((2, 1, 1), grid), out_dir)
    elif task == "pp_fsdp":
        res = pp_fsdp_task()
    elif task == "runtime":
        res = runtime_task()
    else:
        raise SystemExit(f"unknown task {task!r}")
    torch.save(res, Path(out_dir) / f"{task}_rank{rank}.pt")
    shutdown()


def run_task(task: str, out_dir, world: int = 2, timeout: float = 600):
    res = W.run_ranks([sys.executable, str(Path(__file__).resolve()), task,
                       str(out_dir)], world, timeout)
    for rank, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    return [torch.load(Path(out_dir) / f"{task}_rank{r}.pt", weights_only=False)
            for r in range(world)]


if __name__ == "__main__":
    main(*sys.argv[1:])
