"""The port's evaluate CLI against the JAX package's, on the CPU.

``evaluate_dir`` of both packages on the tiny spec's golden params
(4 substreams, as the CLIs write) over three heldout images copied to a
temporary directory: the same records and summary keys, ``bpp``,
``z_bpp`` and ``h_bpp`` equal exactly (the streams are equal), ``psnr``
within 1e-3 dB and ``ms_ssim`` within 1e-4 (fp32 pixels within 1e-3 of each
other).  ``main`` writes the same records, adds ``lpips`` with a
calibration checkpoint (warning that the backbone is seeded), and refuses
``--quant int8`` and ``--base_config`` beside ``--spec``.
"""
import io
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
HELDOUT = ROOT / "artifacts_r05" / "heldout"
PSNR_TOL = 1e-3     # dB
MS_SSIM_TOL = 1e-4


def _lines(buf):
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    for i in (0, 3, 5):
        shutil.copy(HELDOUT / f"val{i}.png", d / f"val{i}.png")
    return d


@pytest.fixture(scope="module")
def port_records(images):
    from sic_tpu_torch import config as tcfg
    from sic_tpu_torch.cli._common import load_runtime
    from sic_tpu_torch.cli.evaluate import evaluate_dir
    rt = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(), device="cpu")
    buf = io.StringIO()
    try:
        summary = evaluate_dir(rt, images, out=buf)
    finally:
        rt.close()
    return _lines(buf), summary


def test_evaluate_dir_matches_jax(images, port_records):
    from sic_tpu.cli.evaluate import evaluate_dir as jevaluate
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models import CodecRuntime as JRuntime
    from fixtures.golden.generate import load_params
    jrt = JRuntime(jtiny(), load_params(GOLDEN / "params.npz"), stream_part=4)
    buf = io.StringIO()
    jsummary = jevaluate(jrt, images, out=buf)
    want = _lines(buf)
    got, summary = port_records
    assert len(got) == len(want) == 4
    for g, w in zip(got[:-1], want[:-1]):
        assert list(g) == list(w)
        for k in ("path", "hw", "bpp", "z_bpp", "h_bpp"):
            assert g[k] == w[k], k
        assert abs(g["psnr"] - w["psnr"]) <= PSNR_TOL
        assert abs(g["ms_ssim"] - w["ms_ssim"]) <= MS_SSIM_TOL
    assert got[-1] == summary and want[-1] == jsummary
    assert list(summary) == list(jsummary)
    for k in ("n", "mean_bpp", "mean_z_bpp", "mean_h_bpp"):
        assert summary[k] == jsummary[k], k
    assert abs(summary["mean_psnr"] - jsummary["mean_psnr"]) <= PSNR_TOL
    assert "ms_ssim" in got[0]                       # 256 px >= 176


def test_main_writes_the_records_and_lpips(images, port_records, tmp_path, capsys):
    """The CLI over the first image: the record of ``evaluate_dir``, plus
    ``lpips`` from a calibration checkpoint on the seeded backbone."""
    from sic_tpu_torch.cli.evaluate import main
    from sic_tpu_torch.models.lpips import CHANNELS
    gen = torch.Generator().manual_seed(7)
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=gen)
                for i, c in enumerate(CHANNELS)}, tmp_path / "lin.pth")
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(images / "val0.png", one / "val0.png")
    buf = io.StringIO()
    main(["--dataset_dir", str(one), "--spec", "tiny", "--device", "cpu",
          "--ckpt_path", str(GOLDEN / "params.npz"),
          "--lpips_lin", str(tmp_path / "lin.pth")], out=buf)
    assert "UNCALIBRATED" in capsys.readouterr().err
    got = _lines(buf)
    want, _ = port_records
    assert len(got) == 2 and got[-1]["n"] == 1 and "mean_lpips" in got[-1]
    assert got[0].pop("lpips") >= 0
    assert {**got[0], "path": ""} == {**want[0], "path": ""}


@pytest.mark.parametrize("argv,message", [
    (["--quant", "int8"], "queue 1 item 9"),
    (["--base_config", str(ROOT / "configs" / "config_small_r4.yaml"),
      "--spec", "tiny"], "--base_config and --spec"),
])
def test_main_refuses(images, capsys, argv, message):
    from sic_tpu_torch.cli.evaluate import main
    with pytest.raises(SystemExit) as e:
        main(["--dataset_dir", str(images), "--device", "cpu", *argv])
    assert e.value.code != 0
    assert message in capsys.readouterr().err
