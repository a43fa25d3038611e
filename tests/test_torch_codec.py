"""The port's decode slice end to end, on the CPU.

- ``golden.c2df`` (encoded by the JAX package) through the port's
  ``decompress`` CLI meets the JAX package's own golden bound.
- The tiny spec with inserts at layers 0 and 1 at 512x512 (2x2 tiles:
  cross-attention, feature refiners, ConvNeXt and 4-window shift masks all
  run): streams written by the JAX package decode in both packages to
  pixels within 1e-3.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from PIL import Image

import jax.numpy as jnp

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.cli._common import load_runtime
from sic_tpu_torch.container import sanitize_enc_result_types, unpack_c2df
from sic_tpu_torch.weights import export_flax_params

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"


def _golden_bound(got: np.ndarray, expected: np.ndarray):
    """test_golden_fixtures.py's bound: max diff <= 1, < 1e-3 of pixels."""
    diff = np.abs(got.astype(np.int32) - expected.astype(np.int32))
    assert diff.max() <= 1, f"max pixel diff {diff.max()}"
    assert (diff != 0).mean() < 1e-3, f"{(diff != 0).mean():%} of pixels changed"


def test_golden_stream_through_the_cli(tmp_path):
    from sic_tpu_torch.cli.decompress import main
    src = tmp_path / "in"
    src.mkdir()
    (src / "golden.c2df").write_bytes((GOLDEN / "golden.c2df").read_bytes())
    n = main(["--dataset_dir", str(src), "--save_dir", str(tmp_path / "out"),
              "--spec", "tiny", "--device", "cpu",
              "--ckpt_path", str(GOLDEN / "params.npz")])
    assert n == 1
    got = np.asarray(Image.open(tmp_path / "out" / "golden.png"))
    _golden_bound(got, np.load(GOLDEN / "expected_u8.npz")["u8"])


def test_golden_stream_device_path_reads_the_same_symbols():
    """The device route (its plain rANS on the CPU) and the host coder read
    the same symbol planes from the JAX-encoded stream."""
    rt = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(), device="cpu")
    enc, header = unpack_c2df(GOLDEN / "golden.c2df")
    enc = sanitize_enc_result_types(enc)
    kw = dict(z_coder=header["z_coder"], coding_batch=header["coding_batch"],
              output="u8")
    host, dev = {}, {}
    x_host = rt.decode_only(**enc, probe=host, **kw)
    rt.device_entropy = "device"
    x_dev = rt.decode_only(**enc, probe=dev, **kw)
    rt.close()
    assert (host["h_path"], dev["h_path"]) == ("host", "device")
    for a, b in zip(host["symbol_planes"], dev["symbol_planes"]):
        assert torch.equal(a, b)
    assert torch.equal(host["h_hat"], dev["h_hat"])
    assert torch.equal(x_host, x_dev)
    _golden_bound(x_dev[0].numpy(), np.load(GOLDEN / "expected_u8.npz")["u8"])


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from sic_tpu_torch.models import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_runtime(None, tcfg.tiny_spec())
    assert resolve_device("cpu").type == "cpu"


def test_torchac_semantic_streams_are_refused_clearly():
    rt = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(), device="cpu")
    with pytest.raises(NotImplementedError, match="torchac"):
        rt._decode_z(b"\x00" * 8, 4, "torchac")
    rt.close()


@pytest.fixture(scope="module")
def tiny512():
    """Port model with seeded weights (every leaf non-zero), its JAX twin,
    and three 512x512 requests whose streams the JAX package wrote."""
    from sic_tpu.models import CodecRuntime as JRuntime
    spec = tcfg.tiny_spec(insert_pos_enc=(0, 1), insert_pos_dec=(0, 1))
    rt = load_runtime(None, spec, device="cpu", stream_part=4)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in rt.model.parameters():
            p.add_(0.02 * torch.from_numpy(rng.standard_normal(p.shape)
                                           .astype(np.float32)))
    from sic_tpu.config import tiny_spec as jtiny
    jspec = jtiny(insert_pos_enc=(0, 1), insert_pos_dec=(0, 1))
    params = {"params": unflatten_dict(export_flax_params(rt.model),
                                       sep="/")["params"]}
    jrt = JRuntime(jspec, params, stream_part=4)
    y = (2.0 * rng.standard_normal((3, 16, 16, 64))).astype(np.float32)
    packed, _ = jrt.h_coder.compress_plan(jnp.asarray(y))
    streams = jrt.h_coder.encode_packed_many(np.asarray(packed))
    encs = []
    for b in range(3):
        z = rng.integers(0, 64, (4, 8)).astype(np.int32)
        encs.append({"z_bit_stream": jrt._encode_z(z.reshape(-1)),
                     "h_bit_stream": streams[b], "img_shape": (512, 512),
                     "feat_shape": (1, 16, 16, 64), "stack_shape": (2, 2),
                     "token_length": 32, "z_indices_shape": (4, 8),
                     "coding_batch": 8, "z_coder": "rans"})
    yield rt, jrt, encs
    rt.close()


def test_tiny_512_jax_streams_decode_alike(tiny512):
    rt, jrt, encs = tiny512
    ref = np.asarray(jrt.decode_only(**encs[0]))
    host, dev = {}, {}
    x = rt.decode_only(**encs[0], probe=host)      # CPU "auto": host coder
    rt.device_entropy = "device"
    try:
        x_dev = rt.decode_only(**encs[0], probe=dev)
    finally:
        rt.device_entropy = "auto"
    assert (host["h_path"], dev["h_path"]) == ("host", "device")
    assert torch.equal(x, x_dev)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_tiny_512_batched_decode_matches_jax_and_single(tiny512):
    rt, jrt, encs = tiny512
    ref = np.asarray(jrt.decode_only_batched(encs))
    batched, single = {}, {}
    x = rt.decode_only_batched(encs, probe=batched)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-3, atol=1e-3)
    # the entropy decode is batch-invariant bit for bit; the pixel decode
    # at another batch size only up to float summation order
    x2 = rt.decode_only(**encs[2], probe=single)
    assert torch.equal(single["h_hat"][0], batched["h_hat"][2])
    torch.testing.assert_close(x2[0], x[2], rtol=1e-4, atol=1e-4)


def test_port_encode_features_round_trip(tiny512):
    """The port's own encode of images (one 256x512 image, and a batch of
    2): every decode, single or batched, reproduces the encoder's y_hat
    bit for bit."""
    rt, _jrt, _ = tiny512
    rng = np.random.default_rng(5)
    x = np.clip(rng.standard_normal((2, 256, 512, 3)), -1, 1).astype(np.float32)
    probe = {}
    enc = rt.encode_only(x[:1], probe=probe)
    out = {}
    rt.decode_only(**enc, coding_batch=8, probe=out)
    assert torch.equal(out["h_hat"], probe["y_hat"])
    probe = {}
    encs = rt.encode_only_batched(x, probe=probe)
    for b, e in enumerate(encs):
        out = {}
        rt.decode_only(**e, coding_batch=8, probe=out)
        assert torch.equal(out["h_hat"], probe["y_hat"][b:b + 1])
    out = {}
    rt.decode_only_batched([dict(e, coding_batch=8) for e in encs], probe=out)
    assert torch.equal(out["h_hat"], probe["y_hat"])
