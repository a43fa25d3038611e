"""The port's YAML reader and ``load_config`` against PyYAML and the JAX
package's ``load_config``, on the CPU.

- Both YAML files in the tree load to the JAX package's spec, strategy,
  loss configs and ``tune_titok`` exactly, and their raw dicts equal
  ``yaml.safe_load``'s (``1e-4`` stays a string, as YAML 1.1 has it).
- Generated documents in the subset (nested block mappings at mixed
  indentation widths, flow sequences, quoted and plain scalars of every
  implicit type, comments, blank lines) read as ``yaml.safe_load`` reads
  them.
- Each construct outside the subset raises ``ValueError`` naming its line.

The tests import PyYAML as the oracle; the package does not.
"""
import dataclasses
import io
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image
from hypothesis import given, settings
from hypothesis import strategies as st

from sic_tpu_torch.config import load_config
from sic_tpu_torch.config_yaml import safe_load
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = [ROOT / "tests" / "fixtures" / "config_tiny.yaml",
           ROOT / "configs" / "config_small_r4.yaml"]


def _asdict(x):
    return None if x is None else dataclasses.asdict(x)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    from sic_tpu.config import load_config as jload
    got, want = load_config(path), jload(path)
    for field in ("spec", "strategy", "feat_cfg", "img_cfg"):
        assert _asdict(getattr(got, field)) == _asdict(getattr(want, field)), field
    assert got.tune_titok is want.tune_titok
    assert got.raw == want.raw == yaml.safe_load(path.read_text())


def test_tiny_config_keeps_yaml_1_1_scalars():
    raw = load_config(CONFIGS[0]).raw
    ts = raw["model"]["params"]["training_strategy"]
    assert ts["learning_rate"] == "1e-4"          # no dot: a string in YAML 1.1
    assert ts["stage0"]["lmbda_list"] == [1.0e-3]
    assert raw["model"]["params"]["no_attn_vqgan"] is False
    assert load_config(CONFIGS[0]).strategy.learning_rate == 1e-4
    assert load_config(CONFIGS[1]).tune_titok is True


# -- generated documents in the subset -------------------------------------------

_TOKENS = ["1e-4", "1.0e-3", "0.001", ".5", "-.inf", ".inf", "+.inf", "1.", "-1.5e+3",
           "1.0e3", "+.5", "yes", "No", "TRUE", "off", "On", "OFF", "y", "n",
           "~", "null", "NULL", "Null", "true", "False", "1:30", "190:20:30.15",
           "+1", "-0", "0", "00", "017", "09", "0o7", "0x1F", "0b101", "1_000",
           "1__0", "_1", "abc", "hello world", "a#b", "x-y", "http://a/b",
           "lpips", "-1", "-x"]

_words = st.from_regex(r"[A-Za-z][A-Za-z0-9_./-]{0,8}( [A-Za-z0-9_]{1,4}){0,2}",
                       fullmatch=True)
_numbers = st.one_of(
    st.integers(-10 ** 9, 10 ** 9).map(str),
    st.floats(allow_nan=False, allow_infinity=False, width=32).flatmap(
        lambda f: st.sampled_from([repr(f), f"{f:.3e}", f"{f:g}", f"{f:.4f}"])))
_plain = st.one_of(st.sampled_from(_TOKENS), _words, _numbers)
_quoted_text = st.text(st.characters(min_codepoint=32, max_codepoint=0x2FF,
                                     blacklist_categories=("Cc",)), max_size=10)
_single = _quoted_text.map(lambda t: "'" + t.replace("'", "''") + "'")
_double = _quoted_text.map(
    lambda t: '"' + t.replace("\\", "\\\\").replace('"', '\\"') + '"')
_scalar = st.one_of(_plain, _single, _double)
_flow = st.lists(_scalar, max_size=5)
_keys = st.one_of(st.from_regex(r"[A-Za-z_][A-Za-z0-9_]{0,8}", fullmatch=True),
                  st.sampled_from(["1", "2.5", "on", "null", "stage0", "'q k'"]))


def _tree(depth):
    leaf = st.one_of(_scalar, _flow)
    if depth == 0:
        return st.dictionaries(_keys, leaf, min_size=1, max_size=4)
    return st.dictionaries(_keys, st.one_of(leaf, _tree(depth - 1)),
                           min_size=1, max_size=4)


@st.composite
def _document(draw):
    tree = draw(_tree(2))
    lines = []

    def extra():
        pick = draw(st.integers(0, 5))
        return {0: "  # " + draw(_words), 1: " #"}.get(pick, "")

    def emit(node, indent):
        step = draw(st.integers(1, 4))
        for key, value in node.items():
            if draw(st.integers(0, 6)) == 0:
                lines.append(draw(st.sampled_from(["", "   ", "# note", " " * indent + "#"])))
            pad = " " * indent
            sep = ":" + " " * draw(st.integers(1, 3))
            if isinstance(value, dict):
                lines.append(pad + key + ":" + extra())
                emit(value, indent + step)
            elif isinstance(value, list):
                gap = " " * draw(st.integers(0, 2))
                body = ("," + gap).join(value)
                lines.append(pad + key + sep + "[" + gap + body + gap + "]" + extra())
            else:
                lines.append(pad + key + sep + value + extra())

    emit(tree, draw(st.integers(0, 2)))
    return "\n".join(lines) + draw(st.sampled_from(["", "\n", "\n\n"]))


@settings(max_examples=300, deadline=None)
@given(_document())
def test_generated_documents_read_as_pyyaml_reads_them(doc):
    assert safe_load(doc) == yaml.safe_load(doc), doc


def test_special_floats():
    got = safe_load("a: .nan\nb: -.Inf\nc: 1_0.5")
    assert math.isnan(got["a"]) and got["b"] == -math.inf and got["c"] == 10.5
    assert safe_load("") is None and safe_load("# only a comment\n\n") is None


# -- constructs outside the subset -----------------------------------------------

@pytest.mark.parametrize("doc,line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: 1\nb: *alias\n", 2),
    ("a: !!str 1\n", 1),
    ("a: !custom x\n", 1),
    ("a: 1\nb: |\n  text\n", 2),
    ("b: >\n  folded\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("---\na: 1\n", 1),
    ("a: 1\n...\n", 2),
    ("%YAML 1.1\na: 1\n", 1),
    ("a:\n\tb: 1\n", 2),
    ("a:\n  - 1\n  - 2\n", 2),
    ("a: {b: 1}\n", 1),
    ("? a\n: 1\n", 1),
    ("a: b\n  continued\n", 2),
    ("a: [1, [2]]\n", 1),
    ("a: [1,\n  2]\n", 1),
    ("a: 'open\n", 1),
    ("a: 2001-12-14\n", 1),
    ("<<: 1\n", 1),
    ("a:\n    b: 1\n  c: 2\n", 3),
    ("a: b: c\n", 1),
    ("[a]: 1\n", 1),
    ("just a scalar\n", 1),
    ("a: 1\nb: '\x80'\n", 2),
], ids=["anchor", "alias", "tag", "local-tag", "literal", "folded",
        "second-document", "document-start", "document-end", "directive",
        "tab-indent", "block-sequence", "flow-mapping", "complex-key",
        "multi-line-plain", "nested-flow", "multi-line-flow", "open-quote",
        "timestamp", "merge-key", "bad-dedent", "nested-mapping-value",
        "flow-key", "bare-scalar", "control-character"])
def test_outside_the_subset_raises_naming_the_line(doc, line):
    with pytest.raises(ValueError, match=rf"line {line}:"):
        safe_load(doc)


# -- --base_config on the CLIs and BASE_CONFIG in the service --------------------

TINY_YAML = CONFIGS[0]


def _shape(png):
    return np.asarray(Image.open(png)).shape


@pytest.fixture(scope="module")
def two_images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    for i in (1, 2):
        shutil.copy(ROOT / "artifacts_r05" / "heldout" / f"val{i}.png", d)
    return d


def test_compress_and_decompress_clis_take_base_config(two_images, tmp_path):
    """config_tiny.yaml's spec (cross-attention at layer 0, one attention
    block) through both CLIs: the streams decode to pixels of the images'
    size; --spec beside --base_config is refused."""
    from sic_tpu_torch.cli.compress import main as compress_main
    from sic_tpu_torch.cli.decompress import main as decompress_main
    common = ["--base_config", str(TINY_YAML), "--device", "cpu"]
    res = compress_main(["--dataset_dir", str(two_images), "--save_dir",
                         str(tmp_path / "c"), *common])
    assert res["images"] == 2
    n = decompress_main(["--dataset_dir", str(tmp_path / "c" / "bitstreams"),
                         "--save_dir", str(tmp_path / "d"), *common])
    assert n == 2
    for p in sorted((tmp_path / "d").glob("*.png")):
        assert _shape(p) == (256, 256, 3)
    with pytest.raises(SystemExit):
        compress_main(["--dataset_dir", str(two_images), "--save_dir",
                       str(tmp_path / "e"), "--spec", "tiny", *common])


def test_load_runtime_takes_base_config():
    from sic_tpu_torch import config as tcfg
    from sic_tpu_torch.cli._common import load_runtime
    rt = load_runtime(None, base_config=str(TINY_YAML), device="cpu")
    rt.close()
    assert rt.spec == load_config(TINY_YAML).spec and rt.z_format == "rans"
    with pytest.raises(ValueError, match="not both"):
        load_runtime(None, tcfg.tiny_spec(), base_config=str(TINY_YAML), device="cpu")


def test_service_serves_the_base_config_spec(monkeypatch, two_images, tmp_path):
    from sic_tpu_torch.service import ServiceState
    monkeypatch.setenv("BASE_CONFIG", str(TINY_YAML))
    state = ServiceState(preview_cache=tmp_path / "previews", index_dir=tmp_path,
                         media_root=tmp_path, device="cpu")
    try:
        assert state.spec == load_config(TINY_YAML).spec
        assert state.runtime.spec == state.spec
        (name, c2df), = state.compress_bytes(
            "val1.png", (two_images / "val1.png").read_bytes())
        (png_name, png), = state.decompress_bytes(name, c2df)
    finally:
        state.close()
    assert png_name == "val1.png" and _shape(io.BytesIO(png)) == (256, 256, 3)


def test_train_cli_takes_base_config(two_images, tmp_path):
    """config_tiny.yaml's spec, strategy (one epoch a stage) and loss
    configs drive the train CLI through its first two stages (the card
    runs all three: chip_smoke.py); a config asking for
    rematerialisation (save_mem) sets spec.remat, which the train CLI
    takes (tests/test_torch_train_bf16.py trains with it); --base_config
    beside --tiny is refused."""
    from sic_tpu_torch.cli.train import main as train_main
    common = ["--device", "cpu", "--train_dir", str(two_images), "--batch_size",
              "2", "--perceptual", "msssim"]
    out = train_main(["--base_config", str(TINY_YAML), "--ckpt_dir",
                      str(tmp_path / "ck"), "--epochs", "2", *common])
    assert out["global_step"] == 2 and out["epoch_for_strategy"] == 2
    assert (tmp_path / "ck" / "feat_wo_bpp_epo_for_strategy_0").exists()
    assert (tmp_path / "ck" / "feat_epo_for_strategy_1").exists()
    from sic_tpu_torch.models import Codec
    from sic_tpu_torch.weights import load_npz
    assert not load_npz(Codec(load_config(TINY_YAML).spec),
                        tmp_path / "ck" / "deploy_params.npz")
    remat = tmp_path / "remat.yaml"
    remat.write_text(TINY_YAML.read_text().replace(
        "    n_attn: 1\n", "    n_attn: 1\n    save_mem: True\n"))
    assert load_config(remat).spec.remat is True
    with pytest.raises(SystemExit):
        train_main(["--base_config", str(TINY_YAML), "--tiny", "--ckpt_dir",
                    str(tmp_path / "x"), *common])
