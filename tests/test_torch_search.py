"""The port's index search and its search and build CLIs against the JAX
package, on the CPU.

- ``VectorIndex.search`` / ``search_many`` on seeded vectors: ids exactly
  the JAX package's (both score bf16-rounded vectors; ties to the lower
  index), scores within 1e-5 (f32 sums in other orders).
- ``search query-c2df`` over the committed ``artifacts_r05`` index: the
  JAX CLI's JSON, paths in the same order, scores within 1e-6.
- ``build build`` over ``artifacts_r05/bitstreams``: index files byte-equal
  to those the JAX CLI writes from the same directory.
- ``build build-images``, ``search query-text`` and ``search query-image``
  on a narrow seeded CLIP, the JAX package's towers under the same params:
  vectors and scores within 1e-4.
"""
import gzip
import json
from pathlib import Path

import numpy as np
import pytest
from flax.traverse_util import unflatten_dict

from sic_tpu_torch.retrieval import VectorIndex
from sic_tpu_torch.weights import export_flax_params

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "artifacts_r05"
INDEX_FILES = ("faiss.index", "paths.json", "meta.json", "index.faiss", "ids.txt")


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _pair(db):
    from sic_tpu.retrieval import VectorIndex as JIndex
    ours, ref = VectorIndex(db.shape[1], device="cpu"), JIndex(db.shape[1])
    names = [f"d{i}" for i in range(len(db))]
    ours.add_batch(db, names)
    ref.add_batch(db, names)
    return ours, ref


def _same(got, want, tol=1e-5):
    (s0, i0), (s1, i1) = got, want
    np.testing.assert_array_equal(i0, np.asarray(i1))
    np.testing.assert_allclose(s0, np.asarray(s1), rtol=tol, atol=tol)


def test_search_matches_jax():
    rng = np.random.default_rng(0)
    ours, ref = _pair(_unit(rng, (500, 64)))
    q = _unit(rng, (16, 64))
    _same(ours.search(q, k=7), ref.search(q, k=7))
    _same(ours.search(q[3], k=1), ref.search(q[3], k=1))
    assert ours.search(q, k=7)[0].dtype == np.float32


def test_search_many_matches_jax_and_serial():
    rng = np.random.default_rng(1)
    ours, ref = _pair(_unit(rng, (300, 32)))
    waves = [_unit(rng, (8, 32)) for _ in range(5)]
    got = ours.search_many(waves, k=5, depth=3)
    for g, w, r in zip(got, waves, ref.search_many(waves, k=5, depth=3)):
        _same(g, r)
        _same(g, ours.search(w, k=5), tol=0)


def test_k_beyond_ntotal_pads_with_minus_one():
    rng = np.random.default_rng(2)
    ours, ref = _pair(_unit(rng, (6, 16)))
    q = _unit(rng, (3, 16))
    s, i = ours.search(q, k=10)
    assert (i[:, 6:] == -1).all() and (s[:, 6:] == 0).all()
    assert sorted(i[0, :6]) == list(range(6))
    _same((s, i), ref.search(q, k=10))
    s, i = VectorIndex(16, device="cpu").search(q, k=4)
    assert (i == -1).all() and (s == 0).all()


def test_ties_go_to_the_lower_index():
    """Duplicated vectors score equal; the lower index comes first, as
    lax.top_k orders them."""
    rng = np.random.default_rng(3)
    base = _unit(rng, (4, 16))
    db = np.concatenate([base, base[::-1], base])       # each vector 3 times
    ours, ref = _pair(db)
    s, i = ours.search(base[1], k=6)
    assert list(i[0, :3]) == [1, 6, 9]
    _same((s, i), ref.search(base[1], k=6))


def _cli_json(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_query_c2df_matches_jax_cli(capsys):
    from sic_tpu.cli.search import main as jmain
    from sic_tpu_torch.cli.search import main
    argv = ["query-c2df", "--index_dir", str(ART / "faiss"),
            "--c2df", str(ART / "bitstreams" / "val3.c2df"), "--topk", "8"]
    ours = _cli_json(main, argv + ["--device", "cpu"], capsys)
    ref = _cli_json(jmain, argv, capsys)
    assert [r["path"] for r in ours] == [r["path"] for r in ref]
    np.testing.assert_allclose([r["score"] for r in ours],
                               [r["score"] for r in ref], rtol=0, atol=1e-6)
    assert [Path(r["path"]).stem for r in ours[:3]] == ["val3", "val4", "val6"]


def test_build_from_c2df_writes_the_jax_bytes(tmp_path):
    from sic_tpu.cli.build import main as jmain
    from sic_tpu_torch.cli.build import main
    src = str(ART / "bitstreams")
    main(["build", "--c2df_dir", src, "--index_dir", str(tmp_path / "port")])
    jmain(["build", "--c2df_dir", src, "--index_dir", str(tmp_path / "jax")])
    for name in INDEX_FILES:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    index, meta = VectorIndex.load(tmp_path / "port", device="cpu")
    assert index.ntotal == 8 and meta["dim"] == 512


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """The port's ClipCodec on a narrow seeded CLIP, and the JAX one under
    the same params, both with one tiny BPE merges file."""
    from sic_tpu.retrieval import ClipCodec as JClip
    from sic_tpu.retrieval import CLIPSpec as JSpec
    from sic_tpu_torch.retrieval import ClipCodec, CLIPSpec
    bpe = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nr e\nre d</w>\nc a\nca t</w>\nd o\ndo g</w>\n")
    kw = dict(vision_width=64, vision_layers=1, vision_heads=1, embed_dim=32,
              text_width=64, text_layers=2, text_heads=2)
    clip = ClipCodec(spec=CLIPSpec(**kw), device="cpu", seed=3, bpe_path=str(bpe))
    params = unflatten_dict(export_flax_params(clip.model), sep="/")
    return clip, JClip(params=params, spec=JSpec(**kw), bpe_path=str(bpe))


def test_build_images_and_query_text_match_jax(clip_pair, tmp_path, capsys,
                                               monkeypatch):
    from sic_tpu.cli import build as jbuild
    from sic_tpu.cli import search as jsearch
    from sic_tpu.retrieval import read_flat_index as jread
    from sic_tpu_torch.cli import build, search
    clip, jclip = clip_pair
    for mod, codec in ((build, clip), (search, clip), (jbuild, jclip),
                       (jsearch, jclip)):
        monkeypatch.setattr(mod, "load_clip_codec", lambda *a, c=codec, **k: c)
    img_dir = str(ART / "heldout")
    build.main(["build-images", "--image_dir", img_dir, "--index_dir",
                str(tmp_path / "port"), "--batch_size", "3", "--device", "cpu"])
    jbuild.main(["build-images", "--image_dir", img_dir, "--index_dir",
                 str(tmp_path / "jax"), "--batch_size", "3"])
    for name in ("paths.json", "meta.json", "ids.txt"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name
    v, _ = jread(tmp_path / "port" / "faiss.index")
    jv, _ = jread(tmp_path / "jax" / "faiss.index")
    assert v.shape == (8, 32)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-4)

    argv = ["query-text", "--text", "a red cat and a dog", "--topk", "8",
            "--index_dir"]
    ours = _cli_json(search.main, argv + [str(tmp_path / "port"), "--device",
                                          "cpu"], capsys)
    ref = _cli_json(jsearch.main, argv + [str(tmp_path / "jax")], capsys)
    assert len(ours) == 8
    assert [r["path"] for r in ours] == [r["path"] for r in ref]
    np.testing.assert_allclose([r["score"] for r in ours],
                               [r["score"] for r in ref], rtol=1e-4, atol=1e-4)


def test_query_image_matches_jax_cli(clip_pair, tmp_path, capsys, monkeypatch):
    """query-image reads the file as the JAX CLI does (through [-1, 1]
    floats, which lowers pixel values 1-63 by one); val5 holds such
    values, so the PIL image the service takes would rank otherwise."""
    from PIL import Image

    from sic_tpu.cli import search as jsearch
    from sic_tpu_torch.cli import build, search
    clip, jclip = clip_pair
    for mod, codec in ((build, clip), (search, clip), (jsearch, jclip)):
        monkeypatch.setattr(mod, "load_clip_codec", lambda *a, c=codec, **k: c)
    image = ART / "heldout" / "val5.png"
    px = np.asarray(Image.open(image))
    assert ((px >= 1) & (px <= 63)).any()
    build.main(["build-images", "--image_dir", str(ART / "heldout"),
                "--index_dir", str(tmp_path), "--device", "cpu"])
    argv = ["query-image", "--image", str(image), "--topk", "8", "--index_dir",
            str(tmp_path)]
    ours = _cli_json(search.main, argv + ["--device", "cpu"], capsys)
    ref = _cli_json(jsearch.main, argv, capsys)
    assert len(ours) == 8
    assert [r["path"] for r in ours] == [r["path"] for r in ref]
    np.testing.assert_allclose([r["score"] for r in ours],
                               [r["score"] for r in ref], rtol=1e-4, atol=1e-4)


def test_build_images_desired_and_model_id(monkeypatch, tmp_path):
    """--desired caps the selection (it wins over --limit) and --model_id
    goes into meta.json (reference: build.py:209-240); a separate
    --download_dir is indexed too."""
    from PIL import Image

    from sic_tpu_torch.cli import build
    rng = np.random.default_rng(4)
    for d, n in (("a", 5), ("b", 2)):
        (tmp_path / d).mkdir()
        for i in range(n):
            Image.fromarray((rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8)
                            ).save(tmp_path / d / f"{d}{i}.png")

    class _StubCodec:
        model_id = "ViT-B-32:laion2b_s34b_b79k"

        class spec:
            embed_dim = 8

        def images_to_unit_vecs(self, batch):
            return _unit(rng, (batch.shape[0], 8))

    monkeypatch.setattr(build, "load_clip_codec", lambda *a, **k: _StubCodec())
    build.main(["build-images", "--image_dir", str(tmp_path / "a"), "--index_dir",
                str(tmp_path / "i1"), "--desired", "3", "--limit", "5",
                "--model_id", "ViT-L-14:laion2b_s32b_b82k"])
    index, meta = VectorIndex.load(tmp_path / "i1")
    assert index.ntotal == 3 and meta["model_id"] == "ViT-L-14:laion2b_s32b_b82k"
    build.main(["build-images", "--image_dir", str(tmp_path / "a"), "--index_dir",
                str(tmp_path / "i2"), "--download_dir", str(tmp_path / "b")])
    assert VectorIndex.load(tmp_path / "i2")[0].ntotal == 7
    # the shortfall helper does nothing without --auto_download
    build.ensure_images_count(tmp_path / "a", desired=99, auto_download=False)
    assert len(list((tmp_path / "a").glob("*.png"))) == 5


def test_search_cli_reports_errors(tmp_path, capsys):
    from sic_tpu_torch.cli.search import main
    with pytest.raises(SystemExit) as e:
        main(["query-c2df", "--index_dir", str(tmp_path), "--c2df",
              str(ART / "bitstreams" / "val0.c2df"), "--device", "cpu"])
    assert e.value.code == 1
    assert "[ERROR] no index found" in capsys.readouterr().out
