"""The train CLI's mesh flags on CPU ranks, over gloo.

Each of ``--tp 2``, ``--tile 2`` and ``--fsdp`` at world size 2, and
``--tp 2 --fsdp`` and ``--tp 2 --tile 2`` at world size 4, trains one
feat step of the tiny spec;
every rank walks one batch sequence, and the run writes ``last`` and a
``deploy_params.npz`` in the one-process layout (the keys and shapes of
the one-process codec, the parameters of ``last``), which the compress and
decompress CLIs read.  Resuming ``last`` in a run with the same flags cuts
it back to each rank's heads and chunks (the resumed run starts from the
same state and takes its step).
"""
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CASES = {"tp": (["--tp", "2"], 2), "tile": (["--tile", "2"], 2),
         "fsdp": (["--fsdp"], 2), "tp_fsdp": (["--tp", "2", "--fsdp"], 4),
         "tp_tile": (["--tp", "2", "--tile", "2"], 4)}


def _images(root, n=2):
    from PIL import Image
    rng = np.random.default_rng(7)
    d = root / "imgs"
    d.mkdir(parents=True)
    for i in range(n):
        arr = (rng.uniform(size=(256, 264 + 8 * i, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i}.png")
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_flags_train_and_deploy(tmp_path, case):
    from sic_tpu_torch.cli.compress import main as compress_main
    from sic_tpu_torch.cli.decompress import main as decompress_main
    from sic_tpu_torch.config import qp_strategy, tiny_spec
    from sic_tpu_torch.train import ImgLossCfg, create_train_state, load_checkpoint
    from sic_tpu_torch.weights import export_flax_params
    flags, world = CASES[case]
    imgs = _images(tmp_path)
    ck = tmp_path / "ck"
    argv = ["--tiny", "--device", "cpu", "--train_dir", str(imgs), "--epochs", "1",
            "--batch_size", "2", "--perceptual", "msssim", "--ckpt_dir", str(ck), *flags]
    res = W.run_train_cli(tmp_path, argv, world=world)
    assert "[train] mesh" in res[0][2]
    deploy = ck / "deploy_params.npz"
    _, state, _ = create_train_state(tiny_spec(), qp_strategy(0), device="cpu",
                                     img_cfg=ImgLossCfg(perceptual="msssim"))
    want = export_flax_params(state.model)
    load_checkpoint(ck / "last", state)
    assert state.global_step == 1
    last = export_flax_params(state.model)
    with np.load(deploy) as z:
        assert set(z.files) == set(want)
        for k in want:
            assert z[k].shape == want[k].shape, k
            np.testing.assert_array_equal(z[k], last[k], err_msg=k)
    out = tmp_path / "out"
    compress_main(["--spec", "tiny", "--ckpt_path", str(deploy), "--device", "cpu",
                   "--dataset_dir", str(imgs), "--save_dir", str(out)])
    decompress_main(["--spec", "tiny", "--ckpt_path", str(deploy), "--device", "cpu",
                     "--dataset_dir", str(out / "bitstreams"),
                     "--save_dir", str(tmp_path / "png")])
    assert len(list((tmp_path / "png").glob("*.png"))) == 2
    if case == "tp_fsdp":
        # the one-process checkpoint resumes on the grid, cut to each rank
        ck2 = tmp_path / "ck2"
        W.run_train_cli(tmp_path, [a if a != str(ck) else str(ck2) for a in argv]
                        + ["--resume", str(ck / "last")], world=world)
        sd = torch.load(ck2 / "last", weights_only=False)
        assert sd["global_step"] == 2
