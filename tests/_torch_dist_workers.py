"""Rank processes for the port's multi-process tests (CPU, gloo).

    python tests/_torch_dist_workers.py <task> <out_dir>

with ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set
(and ``SIC_TEST_DEVICE``, default ``cpu``: ``cuda:0`` puts every rank on
the one card, over gloo).  Each rank writes ``<out_dir>/<task>_rank<r>.pt``,
its tensors on the host.  The module imports
no JAX, so the test files that compare against the JAX package import the
functions below for their one-process references.

Tasks:

- ``dp``: one feat step and one pix step (each from a fresh seeded state)
  on this rank's block of :func:`global_batch`, with the data group; and
  the per-rank values of the batch-coupled terms a step must compute
  globally (the negative controls).
- ``pipeline``: the tiny codec with inserts at (0, 1) (two trunk cells) as
  a two-stage pipeline, forward and backward of :func:`codec_loss` at 2
  and 4 microbatches; then a tiny TiTok encoder trunk through
  ``pipeline_vit_trunk``.
- ``train_cli``: the train CLI with the arguments after ``<out_dir>``,
  recording a digest of every global batch the trainer is handed.

Each rank runs under its own ``PYTHONHASHSEED`` (:func:`rank_env`), so
nothing the ranks must agree on may hang on the hash of a string.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sic_tpu_torch import config as tcfg  # noqa: E402
from sic_tpu_torch.weights import init_seeded  # noqa: E402

DISC = dict(disc_ndf=16, disc_num_layers=2)
DEVICE = os.environ.get("SIC_TEST_DEVICE", "cpu")
PP_SPEC = dict(insert_pos_enc=(0, 1), insert_pos_dec=(0, 1))


def global_batch(n: int = 4, seed: int = 3) -> np.ndarray:
    """(n, 256, 256, 3) in [-1, 1]: one bright textured half and one dark
    flat half, so the two ranks' shares differ in rate and statistics."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 256, 256, 3)).astype(np.float32)
    x[n // 2:] = 0.05 * x[n // 2:] - 0.6
    return x


def train_state(data=None, pp=None, spec=None):
    from sic_tpu_torch.train import ImgLossCfg, create_train_state
    img = ImgLossCfg(perceptual="msssim", **DISC)
    return create_train_state(spec or tcfg.tiny_spec(), tcfg.qp_strategy(0),
                              seed=0, img_cfg=img, device=DEVICE, data=data,
                              pp=pp)


def grads_of(state):
    """Gradients after a step: codec trainable leaves by JAX key, the
    discriminator's by torch name, and its batch statistics."""
    out = {"/".join(path): p.grad.detach().cpu() for path, p in state.trainable}
    out.update({"disc." + n: p.grad.detach().cpu()
                for n, p in state.disc.named_parameters() if p.grad is not None})
    out.update({"stats." + n: b.detach().cpu()
                for n, b in state.disc.named_buffers()})
    return out


def rate_floor(x: np.ndarray, world: int = 2) -> float:
    """A band floor between the ranks' shares' rates under the first step's
    noise, above their mean: the global rate hinge is on, the hinge of the
    share with the highest rate would be off."""
    from sic_tpu_torch.entropy.fourpart import uniform_noise
    from sic_tpu_torch.train.steps import rate_noise_shape
    _, state, _ = train_state()
    g = torch.Generator(state.device).set_state(state.generator.get_state())
    noise = uniform_noise(rate_noise_shape(state.model.spec, x.shape), g, state.device)
    per = len(x) // world
    bpps = []
    with torch.no_grad():
        for r in range(world):
            rows = slice(r * per, (r + 1) * per)
            out = state.model(torch.from_numpy(x[rows]).to(DEVICE), need_full_decode=False,
                              training=True, noise=noise[rows])
            bpps.append(float(out["bpp_loss"]))
    return float(np.mean(bpps) + 0.25 * (max(bpps) - min(bpps)))


def worst_leaf(got: dict, want: dict) -> tuple:
    """(largest leaf error, its key): ``(|got - want| - floor) / |want|``
    with the floor 1e-6 of the whole gradient's norm, for leaves whose
    exact gradient is 0 and which both sides round to noise (a key bias,
    a bias before a GroupNorm): the card-vs-CPU rule of ``PERF.md`` §2."""
    assert set(got) == set(want), set(got) ^ set(want)
    floor = 1e-6 * float(torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())))
    errs = {k: (float((got[k].double() - w.double()).norm()) - floor)
            / max(float(w.double().norm()), 1e-30) for k, w in want.items()}
    k = max(errs, key=errs.get)
    return errs[k], k


def dp_steps(data, x):
    """(feat logs and grads, pix logs and grads, controls) of this rank."""
    from sic_tpu_torch.parallel import all_mean, take_rows
    from sic_tpu_torch.train.losses import adaptive_d_weight
    from sic_tpu_torch.train.steps import _last_conv_apply, rate_noise_shape
    from sic_tpu_torch.entropy.fourpart import uniform_noise
    xl = torch.from_numpy(take_rows(x, data)).to(DEVICE)
    res = {"rows": len(xl)}
    for stage in ("feat", "pix"):
        _, state, steps = train_state(data)
        state.rate_floor = RATE_FLOOR
        step = steps.feat_step if stage == "feat" else steps.pix_step
        logs = step(state, xl)
        res[stage] = ({k: float(v) for k, v in logs.items()}, grads_of(state))

    # the controls: each batch-coupled term as a per-rank step would take it
    _, state, steps = train_state(data)
    g0 = torch.Generator(DEVICE).set_state(state.generator.get_state())
    shape = rate_noise_shape(state.model.spec, xl.shape)
    local = uniform_noise(shape, g0, DEVICE)
    g1 = torch.Generator(DEVICE).set_state(state.generator.get_state())
    glob = take_rows(uniform_noise((shape[0] * data.size, *shape[1:]), g1, DEVICE),
                     data)
    model, disc = state.model, state.disc
    with torch.no_grad():
        out = model(xl, need_full_decode=True, training=True, return_pre_out=True,
                    noise=glob)
    bpp_l = out["bpp_loss"].clone()
    bpp_g = all_mean(out["bpp_loss"].clone(), data)
    conv = model.vqgan.decoder.conv_out
    h_pre, b = out["pre_out"], conv.bias.detach()

    def d_weight(group):
        disc.set_data_group(group)
        nll = lambda w: (torch.mean(torch.abs(xl - _last_conv_apply(h_pre, w, b))))
        g = lambda w: -torch.mean(disc(_last_conv_apply(h_pre, w, b), train=True))
        return float(adaptive_d_weight(
            conv.weight, nll, g, disc_weight=0.75,
            reduce_grad=(lambda t: all_mean(t, group)) if group else (lambda t: t)))

    moments = {}
    hook = disc.bn_1.register_forward_hook(
        lambda m, inp, o: moments.setdefault("x", inp[0].detach()))
    with torch.no_grad():
        disc(xl, train=True)
    hook.remove()
    xb = moments["x"]
    mean_l = xb.mean(dim=(0, 1, 2))
    res["controls"] = {
        "noise": (local.cpu(), glob.cpu()),
        "rate_push": (float(torch.relu(RATE_FLOOR - bpp_l)),
                      float(torch.relu(RATE_FLOOR - bpp_g))),
        "d_weight": (d_weight(None), d_weight(data)),
        "bn_mean": (mean_l.cpu(), all_mean(mean_l.clone(), data).cpu()),
    }
    return res


def codec_loss(out):
    return (torch.mean(torch.abs(out["x"] - out["x_hat"]))
            + 0.1 * out["bpp_loss"] + out["vq_loss"])


def pp_codec(pp=None, spec=None):
    """The tiny codec with two trunk cells a side, seeded, on the CPU (its
    stage's cells only under ``pp``)."""
    from sic_tpu_torch.models import Codec
    torch.manual_seed(0)
    with torch.device(DEVICE):
        m = Codec(spec or tcfg.tiny_spec(**PP_SPEC), None, pp)
    init_seeded(m, 0)
    return m.prune_to_stage()


def codec_grads(model, x, noise):
    from sic_tpu_torch.weights import named_flax_params
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(x).to(DEVICE), need_full_decode=True,
                training=True, noise=noise.to(DEVICE))
    loss = codec_loss(out)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in named_flax_params(model)
             if p.grad is not None}
    return float(loss.detach()), out["x_hat"].detach().cpu(), grads


def pp_noise(x):
    from sic_tpu_torch.train.steps import rate_noise_shape
    g = torch.Generator().manual_seed(5)
    return (torch.rand(rate_noise_shape(tcfg.tiny_spec(), x.shape), generator=g)
            * 2.0 - 1.0) * 0.5


def vit_trunk():
    """(tiny TiTok encoder, (2, 16, width) input) from seeds."""
    from sic_tpu_torch.config import TiTokSpec
    from sic_tpu_torch.models import TiTokEncoderViT
    torch.manual_seed(0)
    enc = TiTokEncoderViT(TiTokSpec(model_size="tiny"))
    init_seeded(enc, 6)
    x = np.random.default_rng(7).standard_normal((2, 16, enc.spec.width)
                                                  ).astype(np.float32)
    return enc, x


def pipeline_checks(pipe):
    from sic_tpu_torch.models.hybrid import PPConfig
    from sic_tpu_torch.parallel import pipeline_vit_trunk
    res = {}
    x = global_batch(4, seed=11)
    noise = pp_noise(x)
    for m in (2, 4):
        model = pp_codec(PPConfig(pipe, m))
        res[f"codec_m{m}"] = codec_grads(model, x, noise)
    enc, xv = vit_trunk()
    with torch.no_grad():
        res["vit"] = pipeline_vit_trunk(enc.to(DEVICE).transformer,
                                        torch.from_numpy(xv).to(DEVICE), pipe,
                                        n_microbatch=2).cpu()
    return res


def train_cli(argv):
    """``sic_tpu_torch.cli.train.main(argv)``; its result, and the sha256 of
    each global batch the trainer took, in order."""
    import hashlib
    from sic_tpu_torch.cli.train import main as train_main
    from sic_tpu_torch.train.trainer import Trainer
    seen, take = [], Trainer._batch

    def recording(self, batch):
        seen.append(hashlib.sha256(np.ascontiguousarray(batch, np.float32)).hexdigest())
        return take(self, batch)

    Trainer._batch = recording
    return {"result": train_main(argv), "batches": seen}


RATE_FLOOR = float(os.environ.get("SIC_TEST_RATE_FLOOR", "0"))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, **extra) -> dict:
    """The torchrun variables of one rank on this host, one intra-op
    thread (ranks share the cores with other test workers), and a string
    hash salt of the rank's own."""
    return dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                OMP_NUM_THREADS="1", PYTHONHASHSEED=str(101 + rank), **extra)


def run_ranks(argv, world: int = 2, timeout: float = 300, **extra):
    """Start ``argv`` once a rank (torchrun's environment), wait for all;
    returns [(returncode, stdout, stderr)] by rank.  A rank that outlives
    ``timeout`` is killed, and so are the others."""
    import subprocess
    port = free_port()
    procs = [subprocess.Popen(argv, cwd=ROOT, env=rank_env(r, world, port, **extra),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def run_task(task: str, out_dir, world: int = 2, timeout: float = 300, **extra):
    """Run a task of this module on ``world`` ranks; their results."""
    res = run_ranks([sys.executable, str(Path(__file__).resolve()), task,
                     str(out_dir)], world, timeout, **extra)
    for rank, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    return [torch.load(Path(out_dir) / f"{task}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def run_train_cli(out_dir, argv, world: int = 2, timeout: float = 300):
    """The train CLI on ``world`` ranks (each its own string hash salt);
    their [(returncode, stdout, stderr)].  Every rank must succeed, and
    the trainers of all ranks must have taken one sequence of global
    batches."""
    res = run_ranks([sys.executable, str(Path(__file__).resolve()), "train_cli",
                     str(out_dir), *argv], world, timeout)
    for rank, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    seen = [torch.load(Path(out_dir) / f"train_cli_rank{r}.pt",
                       weights_only=False)["batches"] for r in range(world)]
    assert seen[0] and all(s == seen[0] for s in seen), seen
    return res


def main(task: str, out_dir: str, *args: str) -> None:
    from sic_tpu_torch.parallel import grid_groups, setup_distributed, shutdown
    torch.set_num_threads(1)
    if task == "train_cli":         # the CLI forms and leaves its own group
        torch.save(train_cli(list(args)),
                   Path(out_dir) / f"{task}_rank{os.environ['RANK']}.pt")
        return
    if DEVICE != "cpu":
        from sic_tpu_torch.models import configure_numerics
        configure_numerics()
    rank, world = setup_distributed(device=DEVICE, placed=DEVICE == "cpu")
    if task == "dp":
        data, _ = grid_groups(1)
        res = dp_steps(data, global_batch())
    elif task == "pipeline":
        _, pipe = grid_groups(world)
        res = pipeline_checks(pipe)
    else:
        raise SystemExit(f"unknown task {task!r}")
    torch.save(res, Path(out_dir) / f"{task}_rank{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
