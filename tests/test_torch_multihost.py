"""The port's multi-process data parallelism against the JAX package and
against its own one-process runs, on the CPU over gloo.

- ``env_world``, ``shard_list`` and ``setup_distributed`` / ``barrier`` at
  world size 1 equal the JAX package's, and world > 1 without a
  coordinator raises its error; the backend follows the topology.
- A rank that dies ends the others with an error: none carries on alone.
- The compress CLI at world size 2 writes the one-process run's bytes and
  index (``tests/test_multihost.py``'s corpus, the tiny YAML config).
- A two-rank feat step and pix step equal the one-process step over the
  whole batch: logs within 1e-5 (feat) and 1e-3 (pix) relative, each
  gradient leaf within 1e-4 (feat) and 5e-3 (pix) of its norm past the
  floor of ``PERF.md`` §2 (1e-6 of the whole gradient's norm), the
  discriminator's statistics within 1e-5.  The batch is chosen so that
  each batch-coupled term taken per rank (the noise rows, the rate
  hinge, the adaptive weight, the BatchNorm moments) lies farther from
  its global value than those limits, and the test asserts it.
- The train CLI on two ranks: both walk one batch sequence, whatever
  each process's string hash salt; rank 0 logs finite losses, rank 1
  nothing, ``last`` is written; the refused flag combinations give the
  JAX CLI's messages.

Ranks are subprocesses (``tests/_torch_dist_workers.py``) on 127.0.0.1
with one intra-op thread each.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY_CFG = str(REPO / "tests" / "fixtures" / "config_tiny.yaml")
ENVS = [{}, {"WORLD_SIZE": "4", "RANK": "2"},
        {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "10.0.0.1",
         "MASTER_PORT": "1234"},
        {"MASTER_ADDR": "h"}]


def _clear(monkeypatch, env):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", ENVS, ids=["empty", "world4", "coord", "addr_only"])
def test_env_world_matches_jax(monkeypatch, env):
    from sic_tpu.parallel.multihost import env_world as jax_env_world
    from sic_tpu_torch.parallel import env_world
    _clear(monkeypatch, env)
    assert env_world() == jax_env_world()


@pytest.mark.parametrize("n,world", [(11, 3), (4, 2), (1, 4), (0, 2)])
def test_shard_list_matches_jax(n, world):
    from sic_tpu.parallel.multihost import shard_list as jax_shard_list
    from sic_tpu_torch import data
    from sic_tpu_torch.parallel import shard_list
    assert shard_list is data.shard_list       # one copy, re-exported
    items = list(range(n))
    for r in range(world):
        assert shard_list(items, r, world) == jax_shard_list(items, r, world)


def test_world_one_is_a_no_op_as_in_jax(monkeypatch):
    from sic_tpu.parallel.multihost import barrier as jbarrier
    from sic_tpu.parallel.multihost import setup_distributed as jsetup
    from sic_tpu_torch.parallel import barrier, setup_distributed
    _clear(monkeypatch, {})
    assert setup_distributed(None, None, None) == jsetup(None, None, None) == (0, 1)
    barrier("noop")
    jbarrier("noop")


def test_multi_process_needs_a_coordinator(monkeypatch):
    from sic_tpu.parallel.multihost import setup_distributed as jsetup
    from sic_tpu_torch.parallel import setup_distributed
    _clear(monkeypatch, {"WORLD_SIZE": "2", "RANK": "1"})
    with pytest.raises(ValueError) as want:
        jsetup()
    with pytest.raises(ValueError) as got:
        setup_distributed(device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("device,cards,local,placed,want", [
    ("cpu", 0, "2", True, "gloo"), ("cuda:0", 1, "2", True, "gloo"),
    ("cuda:1", 2, "2", True, "nccl"), ("cuda:0", 2, "2", False, "gloo"),
    ("cuda:0", 4, "8", True, "gloo"), ("cuda:1", 2, None, True, "nccl"),
    ("cuda:0", 1, None, True, ValueError), ("cuda:0", 1, None, False, "gloo")])
def test_backend_follows_the_topology(monkeypatch, device, cards, local, placed, want):
    """NCCL only with a card for each rank of the host, placed one a card;
    gloo for ranks sharing a card and on the CPU.  More ranks than cards
    without the host's rank count is refused: it may be a multi-node run."""
    from sic_tpu_torch.parallel import choose_backend
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    if want is ValueError:
        with pytest.raises(ValueError, match="set LOCAL_WORLD_SIZE"):
            choose_backend(device, 2, placed)
        return
    backend, why = choose_backend(device, 2, placed)
    assert backend == want and why


def test_a_dead_rank_ends_every_rank(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(
        f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
        "from sic_tpu_torch.parallel import barrier, setup_distributed\n"
        "rank, world = setup_distributed(device='cpu')\n"
        "if rank == 1:\n"
        "    raise SystemExit('rank 1 fails')\n"
        "barrier('after')\n"
        "print('carried on')\n")
    res = W.run_ranks([sys.executable, str(script)], timeout=120)
    assert all(rc != 0 for rc, _, _ in res), [(rc, e[-500:]) for rc, _, e in res]
    assert "carried on" not in res[0][1]
    assert "barrier 'after' failed on rank 0" in res[0][2]


# -- compress ------------------------------------------------------------------

def _corpus(root: Path, n: int = 4):
    """``tests/test_multihost.py``'s synthetic corpus."""
    from PIL import Image
    rng = np.random.default_rng(7)
    img_dir = root / "imgs"
    img_dir.mkdir(parents=True)
    for i in range(n):
        arr = (rng.uniform(size=(80 + 8 * i, 100, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"img_{i}.png")
    return img_dir


def test_two_process_compress_matches_one_process(tmp_path):
    """Batch 2 over four images of one padded shape: two device batches,
    one a rank; every stream byte-equal to the one-process run's, and the
    same index (vectors and order)."""
    from sic_tpu_torch.retrieval import VectorIndex
    img_dir = _corpus(tmp_path)

    def argv(out):
        return [sys.executable, "-m", "sic_tpu_torch.cli.compress",
                "--base_config", TINY_CFG, "--device", "cpu", "--batch_size", "2",
                "--dataset_dir", str(img_dir), "--save_dir", str(out)]

    single = subprocess.run(argv(tmp_path / "single"), cwd=REPO, timeout=300,
                            env=W.rank_env(0, 1, 0), capture_output=True, text=True)
    assert single.returncode == 0, single.stderr[-2000:]
    res = W.run_ranks(argv(tmp_path / "multi"))
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    assert ["compressed 2 images" in err for _, _, err in res] == [True, True]
    a = sorted((tmp_path / "single" / "bitstreams").glob("*.c2df"))
    b = sorted((tmp_path / "multi" / "bitstreams").glob("*.c2df"))
    assert [p.name for p in a] == [p.name for p in b] and len(a) == 4
    for pa, pb in zip(a, b):
        assert pa.read_bytes() == pb.read_bytes(), pa.name
    idx_s, meta_s = VectorIndex.load(tmp_path / "single" / "faiss")
    idx_m, meta_m = VectorIndex.load(tmp_path / "multi" / "faiss")
    np.testing.assert_array_equal(idx_s.vectors(), idx_m.vectors())
    assert [Path(p).name for p in idx_s.ids] == [Path(p).name for p in idx_m.ids]
    assert meta_s == meta_m


def test_batch_plan_matches_the_one_process_buckets(tmp_path):
    """``plan_batches``: full buckets in image order, then the partial ones
    in the order they were opened (the one-process run's batches)."""
    from PIL import Image
    from sic_tpu_torch.cli.compress import plan_batches
    sizes = [(100, 80), (300, 80), (100, 90), (100, 70), (300, 200), (80, 80)]
    paths = []
    for i, (w, h) in enumerate(sizes):
        p = tmp_path / f"{i}.png"
        Image.new("RGB", (w, h)).save(p)
        paths.append(p)
    got = [[p.stem for p in b] for b in plan_batches(paths, 256, 2)]
    assert got == [["0", "2"], ["1", "4"], ["3", "5"]]
    assert [[p.stem for p in b] for b in plan_batches(paths, 256, 2)[1::2]] \
        == [["1", "4"]]


# -- data-parallel steps ---------------------------------------------------------

@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Two ranks' feat and pix steps and controls, and the one-process
    steps over the whole batch, at a rate floor between the shares'."""
    x = W.global_batch()
    floor = W.rate_floor(x)
    ranks = W.run_task("dp", tmp_path_factory.mktemp("dp"),
                       SIC_TEST_RATE_FLOOR=repr(floor))
    ref = {}
    for stage in ("feat", "pix"):
        _, state, steps = W.train_state()
        state.rate_floor = floor
        logs = getattr(steps, f"{stage}_step")(state, torch.from_numpy(x))
        ref[stage] = ({k: float(v) for k, v in logs.items()}, W.grads_of(state))
    return ranks, ref


LIMITS = {"feat": (1e-5, 1e-4), "pix": (1e-3, 5e-3)}


@pytest.mark.parametrize("stage", ["feat", "pix"])
def test_two_rank_step_equals_the_global_step(dp_runs, stage):
    ranks, ref = dp_runs
    loss_tol, grad_tol = LIMITS[stage]
    want_logs, want = ref[stage]
    stats = {k for k in want if k.startswith("stats.")}
    for res in ranks:
        assert res["rows"] == 2
        logs, got = res[stage]
        assert set(logs) == set(want_logs)
        for k, v in want_logs.items():
            assert abs(logs[k] - v) <= loss_tol * abs(v) + 1e-7, (k, logs[k], v)
        err, key = W.worst_leaf({k: got[k] for k in want if k not in stats},
                                {k: want[k] for k in want if k not in stats})
        assert err <= grad_tol, (key, err)
        for k in stats:
            scale = float(want[k].abs().max())
            assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k
    if stage == "pix":       # the statistics moved: real, then fake
        assert not torch.equal(want["stats.bn_1.mean"], torch.zeros_like(want["stats.bn_1.mean"]))
        assert ref["pix"][0]["train/rate_push"] > 0


def test_each_batch_coupled_term_is_global(dp_runs):
    """Negative controls: per rank, each term lies farther from the global
    one than the step tolerances; the steps above used the global ones."""
    ranks, _ = dp_runs
    c0, c1 = ranks[0]["controls"], ranks[1]["controls"]
    local, glob = c1["noise"]          # rank 0's rows start the draw alike
    assert float((local - glob).norm() / glob.norm()) > 0.1
    torch.testing.assert_close(c0["noise"][0], c0["noise"][1], rtol=0, atol=0)
    hinge = [c["rate_push"] for c in (c0, c1)]
    assert hinge[0][1] == hinge[1][1] > 0                 # global: on
    assert min(h[0] for h in hinge) == 0.0                # per rank: one off
    assert max(abs(h[0] - h[1]) / h[1] for h in hinge) > 0.1
    for c in (c0, c1):
        dw_local, dw_global = c["d_weight"]
        assert abs(dw_local - dw_global) > 1e-2 * dw_global
        m_local, m_global = c["bn_mean"]
        assert float((m_local - m_global).norm() / m_global.norm()) > 1e-2
    assert c0["d_weight"][1] == c1["d_weight"][1]


# -- the train CLI ---------------------------------------------------------------

def _train_images(root: Path, n: int = 2):
    from PIL import Image
    rng = np.random.default_rng(7)
    d = root / "imgs"
    d.mkdir(parents=True)
    for i in range(n):
        arr = (rng.uniform(size=(256 + 8 * i, 260, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i}.png")
    return d


def test_epoch_order_is_the_same_in_every_process():
    """The training shuffle hangs on (seed, epoch) alone, not on the string
    hash salt of the process."""
    prog = ("import json, sys; sys.path.insert(0, sys.argv[1])\n"
            "from sic_tpu_torch.data import ImageDataset\n"
            "ImageDataset.__getitem__ = lambda self, i: i\n"
            "ds = ImageDataset([str(i) for i in range(16)], seed=5)\n"
            "print(json.dumps([[b.tolist() for b in ds.batches(4, epoch=e)]\n"
            "                  for e in range(3)]))\n")
    orders = [subprocess.run([sys.executable, "-c", prog, str(REPO)], check=True,
                             capture_output=True, text=True, timeout=120,
                             env=W.rank_env(r, 2, 0)).stdout for r in range(2)]
    assert orders[0] == orders[1]
    epochs = json.loads(orders[0])
    assert epochs[0] != epochs[1] and sorted(sum(epochs[0], [])) == list(range(16))


def test_two_process_train_cli_logs_once_and_checkpoints(tmp_path):
    imgs = _train_images(tmp_path)
    ck = tmp_path / "ck"
    res = W.run_train_cli(tmp_path, ["--tiny", "--device", "cpu", "--train_dir", str(imgs),
                                     "--epochs", "1", "--batch_size", "2",
                                     "--perceptual", "msssim", "--ckpt_dir", str(ck)])
    logs = [json.loads(ln) for ln in res[0][2].splitlines() if ln.startswith("{")]
    losses = [ln for ln in logs if "train/align_loss" in ln]
    assert losses and all(np.isfinite(ln["train/align_loss"]) for ln in losses)
    assert not [ln for ln in res[1][2].splitlines() if ln.startswith("{")]
    assert (ck / "last").exists()
    assert not (ck / "deploy_params.npz").exists()   # the JAX CLI's rule
    assert torch.load(ck / "last", weights_only=False)["global_step"] == 1


def _message(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("extra,env,want", [
    (["--pp", "4"], {}, "encoder trunk has 2 pipeline cells; --pp must divide "
     "it (got 4)"),
    (["--pp", "2"], {"WORLD_SIZE": "3"}, "3 processes not divisible by pp=2"),
    (["--pp", "2", "--batch_size", "3"], {"WORLD_SIZE": "2"},
     "--batch_size 3 must be a multiple of microbatches*data = 2*1 (each "
     "microbatch shards over the data axis)"),
    (["--pp", "2", "--pp_microbatch", "2", "--batch_size", "2"], {"WORLD_SIZE": "4"},
     "--batch_size 2 must be a multiple of microbatches*data = 2*2 (each "
     "microbatch shards over the data axis)"),
    (["--batch_size", "3"], {"WORLD_SIZE": "2"},
     "--batch_size 3 must divide by world_size 2"),
    (["--pp", "2", "--tp", "2"], {}, "not with --tp/--tile"),
    (["--tp", "2"], {"WORLD_SIZE": "3"}, "3 processes not divisible by tp*tile=2"),
    (["--tile", "2", "--batch_size", "3"], {"WORLD_SIZE": "4"},
     "--batch_size 3 must divide by the data-axis size 2"),
    (["--fsdp", "--batch_size", "3"], {"WORLD_SIZE": "2"},
     "--batch_size 3 must divide by world_size 2")],
    ids=["cells", "processes", "microbatch", "microbatch_data", "dp_batch",
         "pp_tp", "tp", "tile", "fsdp"])
def test_refused_flags_give_the_jax_messages(tmp_path, monkeypatch, capsys,
                                             extra, env, want):
    """Each refusal before any rank waits for another.  Where the JAX CLI
    refuses the same flags before building its model, its message is
    compared too; the rest are its f-strings with the port's counts
    (processes for devices).  The mesh flags (``tp``, ``tile``, ``fsdp``)
    run now (``tests/test_torch_mesh_cli.py``); their cases here are the
    JAX CLI's divisibility refusals of them."""
    from sic_tpu_torch.cli.train import main
    imgs = _train_images(tmp_path)
    _clear(monkeypatch, env)
    argv = ["--tiny", "--device", "cpu", "--train_dir", str(imgs),
            "--insert_pos", "0", "1", *extra]
    got = _message(main, argv, capsys)
    assert want in got, got
    if extra == ["--pp", "4"] or extra[-2:] == ["--tp", "2"] and "--pp" in extra:
        from sic_tpu.cli.train import main as jax_main
        monkeypatch.setenv("SIC_XLA_CACHE", "off")
        jax_got = _message(jax_main, [a for a in argv if a not in ("--device", "cpu")],
                           capsys)
        if "--tp" in extra:     # the JAX CLI also names --fsdp and multi-host
            assert "not with --tp/--tile" in jax_got, jax_got
        else:
            assert got == jax_got
