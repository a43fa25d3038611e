"""The port's train CLI end to end on the CPU, tiny spec.

Two images, a one-epoch-a-stage schedule: ``feat_wo_bpp`` -> ``feat`` ->
``pix`` with validation, a checkpoint at each stage change and ``last``;
then a resume of ``last`` with ``--reset_schedule``; then the
``deploy_params.npz`` it writes, read by the compress CLI's ``--ckpt_path``,
and the streams decoded with the same params.
"""
import numpy as np
import torch
from PIL import Image

from sic_tpu_torch import config
from sic_tpu_torch.train import ImgLossCfg, StageSpec, TrainingStrategy
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _one_epoch_stages(qp, train_px=256):
    return TrainingStrategy(
        learning_rate=1e-4, start_epoch=0,
        stages=(StageSpec(1, 0, (1e-3, 1.0), 2.0, 0.001),
                StageSpec(1, 0, (1.0, 2.0), 0.012, 0.007),
                StageSpec(1, 0, (1.0, 2.0), 0.015, 0.010)))


def test_train_cli_stages_resume_and_deploy(tmp_path, monkeypatch):
    from sic_tpu_torch.cli.compress import main as compress_main
    from sic_tpu_torch.cli.train import main as train_main
    from sic_tpu_torch.container import unpack_c2df
    from sic_tpu_torch.train import load_checkpoint
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:256, 0:300]
    for i in range(2):
        base = 127 + 100 * np.sin(xx / (7.0 + i) + np.arange(3)[:, None, None]) \
            * np.cos(yy / 11.0)
        img = np.clip(base.transpose(1, 2, 0) + rng.normal(0, 20, (256, 300, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(imgs / f"im{i}.png")
    monkeypatch.setattr(config, "qp_strategy", _one_epoch_stages)
    ckpt = tmp_path / "ckpt"
    common = ["--tiny", "--device", "cpu", "--train_dir", str(imgs), "--val_dir",
              str(imgs), "--batch_size", "2", "--ckpt_dir", str(ckpt),
              "--perceptual", "msssim"]
    out = train_main(common)
    assert out["global_step"] == 3 and out["epoch_for_strategy"] == 3
    names = sorted(p.name for p in ckpt.iterdir())
    assert names == ["deploy_params.npz", "feat_epo_for_strategy_1",
                     "feat_wo_bpp_epo_for_strategy_0", "last"]
    ck = torch.load(ckpt / "last", weights_only=False)
    assert ck["epoch_for_strategy"] == 3 and ck["global_step"] == 3
    # the pix stage moved the VQGAN decoder; the frozen teacher did not
    before = torch.load(ckpt / "feat_epo_for_strategy_1", weights_only=False)["model"]
    key = "vqgan.decoder.conv_out.weight"
    assert not torch.equal(before[key], ck["model"][key])
    first = torch.load(ckpt / "feat_wo_bpp_epo_for_strategy_0", weights_only=False)["model"]
    assert torch.equal(first[key], before[key])
    teacher = "vqgan.encoder.conv_in.weight"
    assert torch.equal(first[teacher], ck["model"][teacher])

    # resume the weights and restart the schedule: one more feat_wo_bpp epoch
    out2 = train_main(common + ["--resume", str(ckpt / "last"), "--reset_schedule",
                                "--epochs", "1", "--ckpt_dir", str(tmp_path / "ckpt2")])
    assert out2["global_step"] == 4 and out2["epoch_for_strategy"] == 1
    assert (tmp_path / "ckpt2" / "feat_wo_bpp_epo_for_strategy_0").exists()
    from sic_tpu_torch.config import tiny_spec
    from sic_tpu_torch.train import create_train_state
    _, state, _ = create_train_state(tiny_spec(), _one_epoch_stages(0), device="cpu",
                                     img_cfg=ImgLossCfg(perceptual="msssim"))
    load_checkpoint(tmp_path / "ckpt2" / "last", state)
    assert state.global_step == 4 and state.epoch_for_strategy == 1

    # the deployment params through the compress CLI, and its streams decoded
    res = compress_main(["--dataset_dir", str(imgs), "--save_dir", str(tmp_path / "c"),
                         "--ckpt_path", str(ckpt / "deploy_params.npz"),
                         "--spec", "tiny", "--device", "cpu"])
    assert res["images"] == 2
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.container import sanitize_enc_result_types
    rt = load_runtime(str(ckpt / "deploy_params.npz"), tiny_spec(), device="cpu")
    for f in sorted((tmp_path / "c" / "bitstreams").glob("*.c2df")):
        enc, header = unpack_c2df(f)
        enc = sanitize_enc_result_types(enc)
        x = rt.decode_only(**enc, z_coder=header["z_coder"],
                           coding_batch=header["coding_batch"], output="u8")
        assert x.shape == (1, 256, 512, 3)
    rt.close()
