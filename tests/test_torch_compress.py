"""The port's encode slice end to end, on the CPU.

- ``golden_input()`` under the committed params encodes to the bytes of
  ``golden.c2df`` (the counterpart of ``test_golden_fixtures.py``'s
  re-encode test).
- The tiny spec with inserts at layers 0 and 1 (cross-attention, feature
  refiners, shift masks in the encoder and decoder) on one 256x768 image
  and a batch of three 512x512: the JAX package's bytes, the device coder
  (its plain rANS on the CPU) equal to the host coder, and every stream
  decoding to the encoder's y_hat bit for bit.
- ``compress_dir`` against the JAX package's, with the same weights for
  the codec and a narrow CLIP tower: equal ``.c2df`` bytes, clip vectors
  within 1e-4, equal index files.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from PIL import Image

import jax.numpy as jnp

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.cli._common import load_runtime
from sic_tpu_torch.container import pack_c2df
from sic_tpu_torch.weights import export_flax_params

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"
HEADER = {"version": 2, "image_hw": [256, 256], "padding": [0, 0, 0, 0],
          "z_coder": "rans", "coding_batch": 8}


def _golden_input():
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import golden_input
    return golden_input()


@pytest.mark.parametrize("entropy", ["host", "device"])
def test_golden_input_encodes_to_golden_bytes(entropy):
    rt = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(),
                      device="cpu", stream_part=1)
    rt.device_entropy = entropy
    probe = {}
    enc = rt.encode_only_batched(_golden_input()[None], probe=probe)[0]
    rt.close()
    assert probe["h_path"] == entropy
    assert pack_c2df(enc, HEADER) == (GOLDEN / "golden.c2df").read_bytes()


@pytest.fixture(scope="module")
def pair():
    """Port runtime with seeded weights (every leaf non-zero) and its JAX
    twin over the same weights, 4 substreams.

    The bottleneck takes half-lecun weights, which keep its activations
    O(1) as trained weights do (symbols within +-4 here).  The seeded
    initialisation's residual growth gives symbols in the thousands, where
    the two frameworks' last-bit float differences (about 2e-6 in the
    detail features) cross a rounding boundary once in a few thousand
    positions; no decoder of a foreign stream survives that (ROADMAP
    section 3), and no trained codec writes such planes."""
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models import CodecRuntime as JRuntime
    from test_torch_bottleneck import _randomize
    spec = tcfg.tiny_spec(insert_pos_enc=(0, 1), insert_pos_dec=(0, 1))
    rt = load_runtime(None, spec, device="cpu", stream_part=4)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for p in rt.model.parameters():
            p.add_(0.02 * torch.from_numpy(rng.standard_normal(p.shape)
                                           .astype(np.float32)))
    _randomize(rt.model.hybrid_codec.quantize_feat, 2)
    params = {"params": unflatten_dict(export_flax_params(rt.model),
                                       sep="/")["params"]}
    jrt = JRuntime(jtiny(insert_pos_enc=(0, 1), insert_pos_dec=(0, 1)),
                   params, stream_part=4)
    yield rt, jrt
    rt.close()


def _images(B, H, W, seed):
    """Smooth images with texture in [-1, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / 64.0
    base = np.stack([np.sin(xx + 0.5 * c) * np.cos(yy - c) for c in range(3)], -1)
    return np.clip(0.7 * base[None] + 0.2 * rng.standard_normal((B, H, W, 3)),
                   -1, 1).astype(np.float32)


@pytest.mark.parametrize("B,H,W", [(1, 256, 768), (3, 512, 512)])
def test_encode_matches_jax_and_decodes_bit_exact(pair, B, H, W):
    rt, jrt = pair
    x = _images(B, H, W, B * H + W)
    want = jrt.encode_only_batched(jnp.asarray(x))
    probes = {}
    got = {}
    for entropy in ("host", "device"):
        rt.device_entropy = entropy
        probes[entropy] = {}
        got[entropy] = rt.encode_only_batched(x, probe=probes[entropy])
    rt.device_entropy = "auto"
    assert probes["device"]["h_path"] == "device"
    for g, h, w in zip(got["device"], got["host"], want):
        assert g["h_bit_stream"] == h["h_bit_stream"] == w["h_bit_stream"]
        assert g["z_bit_stream"] == h["z_bit_stream"] == w["z_bit_stream"]
        for k in ("img_shape", "feat_shape", "stack_shape", "token_length",
                  "z_indices_shape"):
            assert tuple(np.atleast_1d(g[k])) == tuple(np.atleast_1d(w[k])), k
    y_hat = probes["device"]["y_hat"]
    assert torch.equal(y_hat, probes["host"]["y_hat"])
    for b, enc in enumerate(got["device"]):
        probe = {}
        rt.decode_only(**enc, coding_batch=8, probe=probe)
        assert torch.equal(probe["h_hat"], y_hat[b:b + 1])
    if B > 1:
        probe = {}
        rt.decode_only_batched([dict(e, coding_batch=8) for e in got["device"]],
                               probe=probe)
        assert torch.equal(probe["h_hat"], y_hat)


def test_encode_decode_reports_bpp(pair):
    rt, _ = pair
    x = _images(1, 256, 256, 7)
    x_hat, bpp, enc = rt.encode_decode(x, (256, 256))
    assert tuple(x_hat.shape) == (1, 256, 256, 3)
    assert bpp["total_bpp"] == pytest.approx(
        (8 * len(enc["z_bit_stream"]) + 8 * len(enc["h_bit_stream"]) + 48)
        / 256 ** 2)


def _clip_pair(seed=0):
    """Port ClipCodec and the JAX one over the same narrow tower."""
    from sic_tpu.retrieval import ClipCodec as JClip
    from sic_tpu.retrieval import CLIPSpec as JSpec
    from sic_tpu_torch.retrieval import ClipCodec, CLIPSpec
    kw = dict(vision_width=128, vision_layers=2, vision_heads=2, embed_dim=64)
    clip = ClipCodec(spec=CLIPSpec(**kw), device="cpu", seed=seed)
    params = unflatten_dict(export_flax_params(clip.model), sep="/")
    return clip, JClip(params=params, spec=JSpec(**kw))


def test_compress_dir_matches_jax(pair, tmp_path):
    from sic_tpu.cli.compress import compress_dir as jcompress_dir
    from sic_tpu_torch.cli.compress import compress_dir
    rt, jrt = pair
    src = tmp_path / "imgs"
    src.mkdir()
    # one bucket of three 512x512 images, one of them replicate-padded
    for i, (h, w) in enumerate([(512, 512), (480, 500), (512, 512)]):
        u8 = ((_images(1, h, w, 40 + i)[0] + 1) * 127.5).astype(np.uint8)
        Image.fromarray(u8).save(src / f"im{i}.png")
    clip, jclip = _clip_pair()
    assert compress_dir(rt, clip, src, tmp_path / "port") == 3
    assert jcompress_dir(jrt, jclip, src, tmp_path / "jax") == 3
    for i in range(3):
        stem = f"im{i}"
        assert (tmp_path / "port" / "bitstreams" / f"{stem}.c2df").read_bytes() == \
            (tmp_path / "jax" / "bitstreams" / f"{stem}.c2df").read_bytes()
        np.testing.assert_allclose(
            np.load(tmp_path / "port" / "clip_vecs" / f"{stem}.npy"),
            np.load(tmp_path / "jax" / "clip_vecs" / f"{stem}.npy"),
            rtol=1e-4, atol=1e-4)
    for name in ("paths.json", "meta.json", "ids.txt"):
        assert (tmp_path / "port" / "faiss" / name).read_text().replace(
            "/port/", "/jax/") == (tmp_path / "jax" / "faiss" / name).read_text()


def test_clip_payload_and_index_files_match_jax(tmp_path):
    from sic_tpu.retrieval import VectorIndex as JIndex
    from sic_tpu.retrieval import codec as jcodec
    from sic_tpu.retrieval import read_flat_index as jread
    from sic_tpu_torch.retrieval import (VectorIndex, decode_clip_stream,
                                         read_flat_index)
    clip, jclip = _clip_pair()
    vecs = jcodec.l2n(np.random.default_rng(1).standard_normal((5, 64))
                      .astype(np.float32))
    for v in vecs:
        payload, meta = clip.quantize_u8_and_compress(v)
        jpayload, jmeta = jclip.quantize_u8_and_compress(v)
        assert payload == jpayload and meta == jmeta
        np.testing.assert_array_equal(decode_clip_stream(payload, meta),
                                      jcodec.decode_clip_stream(payload, meta))
    ids = [f"doc{i}" for i in range(5)]
    port, jax_ = VectorIndex(64), JIndex(64)
    port.add(vecs[0], ids[0])
    port.add_batch(vecs[1:], ids[1:])
    jax_.add(vecs[0], ids[0])
    jax_.add_batch(vecs[1:], ids[1:])
    port.persist(tmp_path / "p")
    jax_.persist(tmp_path / "j")
    for name in ("faiss.index", "index.faiss", "paths.json", "meta.json", "ids.txt"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    v, metric = read_flat_index(tmp_path / "j" / "faiss.index")
    jv, jmetric = jread(tmp_path / "p" / "faiss.index")
    np.testing.assert_array_equal(v, jv)
    assert metric == jmetric == "ip"
    loaded, meta = VectorIndex.load(tmp_path / "p")
    assert loaded.ids == ids and meta["dim"] == 64
    np.testing.assert_array_equal(loaded.vectors(), port.vectors())
    # the text side, ported since: the same unit vectors as the JAX codec's
    np.testing.assert_allclose(clip.text_to_unit_vec("a photo"),
                               jclip.text_to_unit_vec("a photo"),
                               rtol=1e-4, atol=1e-4)


def test_encode_router_decides_as_jax():
    """One scripted feed of fetches, device encodes and decisions gives
    the same decision sequence in both packages."""
    from sic_tpu.models.codec import EncodeRouter as JRouter
    from sic_tpu_torch.models import EncodeRouter
    rng = np.random.default_rng(2)
    routers = [EncodeRouter(explore_every=5), JRouter(explore_every=5)]
    decisions = [[], []]
    for step in range(60):
        kind = step % 3
        nbytes = int(rng.integers(1 << 16, 1 << 22))
        secs = float(rng.uniform(1e-4, 5e-2))
        n_chunks = int(rng.integers(1, 4))
        for r, out in zip(routers, decisions):
            if kind == 0:
                r.note_fetch(nbytes, secs)
            elif kind == 1:
                r.note_device_encode(secs, nbytes // 8, nbytes, n_chunks)
            out.append((r.decide(nbytes, n_chunks), r.last_explored))
    assert decisions[0] == decisions[1]
    assert {d for d, _ in decisions[0]} == {True, False}


def test_compress_cli_needs_a_card_or_cpu(monkeypatch, tmp_path):
    from sic_tpu_torch.cli.compress import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset_dir", str(tmp_path), "--save_dir", str(tmp_path / "o"),
              "--spec", "tiny"])
