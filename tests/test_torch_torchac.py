"""The port's torchac z-stream coder and its wiring, against the JAX
package's, on the CPU.

- ``UniformTorchacCodec(4096)``: for 1, 7, 512 and 3000 seeded tokens the
  port writes the JAX coder's bytes and reads the JAX bytes back; float
  CDFs (one row, a row a symbol) likewise.
- The adversarial inputs of ``tests/test_torchac_compat.py`` (truncated
  streams, garbage, a lying token count, bit flips, an empty stream, no
  symbols): the port decodes exactly what the JAX coder decodes, always
  ``n_sym`` in-alphabet symbols.
- A tiny-spec ``.c2df`` packed by the JAX runtime with
  ``z_format="torchac"`` (golden params), once with ``z_coder`` in its
  header and once without (as the reference writes files), through the
  port's decompress CLI (alone and batched: ``decode_only_batched``) and its
  service: PNGs within u8 max diff 1 of the JAX CLI's.  The port's
  ``z_format="torchac"`` runtime writes the JAX runtime's z bytes.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sic_tpu.entropy import torchac_compat as jtac
from sic_tpu_torch.entropy import torchac_compat as tac

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"


@pytest.mark.parametrize("n", [1, 7, 512, 3000])
def test_uniform_codec_bytes_equal_jax(n):
    toks = np.random.default_rng(n).integers(0, 4096, n).astype(np.int16)
    want = jtac.UniformTorchacCodec(4096).encode(toks)
    codec = tac.UniformTorchacCodec(4096)
    assert codec.encode(toks) == want
    np.testing.assert_array_equal(codec.decode(want, n), toks)


def test_float_cdfs_equal_jax():
    rng = np.random.default_rng(3)
    K = 37
    pmf = rng.dirichlet(np.ones(K)).astype(np.float32)
    row = np.zeros(K + 1, np.float32)
    row[1:] = np.cumsum(pmf)
    row[-1] = 1.0
    toks = rng.choice(K, size=500, p=pmf.astype(np.float64) / pmf.sum())
    np.testing.assert_array_equal(tac.quantize_cdf(row), jtac.quantize_cdf(row))
    np.testing.assert_array_equal(tac.uniform_cdf(4096), jtac.uniform_cdf(4096))
    stream = tac.encode_float_cdf(row, toks)
    assert stream == jtac.encode_float_cdf(row, toks)
    np.testing.assert_array_equal(tac.decode_float_cdf(row, stream, 500), toks)
    rows = np.stack([row] * 64)
    stream = tac.encode_float_cdf(rows, toks[:64])
    assert stream == jtac.encode_float_cdf(rows, toks[:64])
    np.testing.assert_array_equal(tac.decode_float_cdf(rows, stream, 64), toks[:64])


def _same_as_jax(num_codes, stream, n_sym):
    got = tac.UniformTorchacCodec(num_codes).decode(stream, n_sym)
    want = jtac.UniformTorchacCodec(num_codes).decode(stream, n_sym)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n_sym,)
    if n_sym:
        assert got.min() >= 0 and got.max() < num_codes


@pytest.mark.parametrize("cut", [0, 1, 2, 3, 7, 100])
def test_truncated_stream_decodes_as_jax(cut):
    toks = np.random.default_rng(cut).integers(0, 4096, 512).astype(np.int16)
    stream = tac.UniformTorchacCodec(4096).encode(toks)
    _same_as_jax(4096, stream[:cut], 512)


def test_empty_stream_decodes_as_jax():
    _same_as_jax(4096, b"", 64)


@pytest.mark.parametrize("seed", range(8))
def test_random_garbage_decodes_as_jax(seed):
    rng = np.random.default_rng(seed)
    garbage = rng.integers(0, 256, rng.integers(0, 200)).astype(np.uint8)
    _same_as_jax(257, garbage.tobytes(), 333)


@pytest.mark.parametrize("extra", [1, 10, 1000])
def test_n_sym_overrun_decodes_as_jax(extra):
    toks = np.random.default_rng(extra).integers(0, 100, 50).astype(np.int16)
    stream = tac.UniformTorchacCodec(100).encode(toks)
    out = tac.UniformTorchacCodec(100).decode(stream, 50 + extra)
    np.testing.assert_array_equal(out[:50], toks)
    _same_as_jax(100, stream, 50 + extra)


def test_bitflip_fuzz_decodes_as_jax():
    rng = np.random.default_rng(99)
    toks = rng.integers(0, 4096, 128).astype(np.int16)
    stream = bytearray(tac.UniformTorchacCodec(4096).encode(toks))
    for _ in range(32):
        stream[rng.integers(0, len(stream))] ^= 1 << rng.integers(0, 8)
        _same_as_jax(4096, bytes(stream), 128)


def test_zero_symbols_round_trip():
    codec = tac.UniformTorchacCodec(16)
    stream = codec.encode(np.empty(0, np.int16))
    assert stream == jtac.UniformTorchacCodec(16).encode(np.empty(0, np.int16))
    assert codec.decode(stream, 0).shape == (0,)


# -- reference-format files through the port ---------------------------------

def _golden_input():
    sys.path.insert(0, str(GOLDEN.parents[1]))
    from fixtures.golden.generate import golden_input
    return golden_input()


@pytest.fixture(scope="module")
def torchac_files(tmp_path_factory):
    """The golden input encoded by the JAX runtime (golden params, 4
    substreams, z_format="torchac"), packed with and without ``z_coder``;
    the JAX CLI's PNG of the file; the JAX encode."""
    import jax.numpy as jnp
    from sic_tpu.cli.decompress import decompress_dir
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.container import pack_c2df
    from sic_tpu.models import CodecRuntime as JRuntime
    from fixtures.golden.generate import load_params
    root = tmp_path_factory.mktemp("torchac")
    jrt = JRuntime(jtiny(), load_params(GOLDEN / "params.npz"), stream_part=4,
                   z_format="torchac")
    enc = jrt.encode_only(jnp.asarray(_golden_input()[None]))
    header = {"version": 2, "image_hw": [256, 256], "padding": [0, 0, 0, 0],
              "z_coder": "torchac", "coding_batch": jrt.h_coder.coding_batch}
    files = root / "files"
    files.mkdir()
    (files / "with_key.c2df").write_bytes(pack_c2df(enc, header))
    header.pop("z_coder")
    (files / "reference.c2df").write_bytes(pack_c2df(enc, header))
    decompress_dir(jrt, files, root / "jax_png")
    want = np.asarray(Image.open(root / "jax_png" / "with_key.png")).astype(np.int32)
    assert np.array_equal(
        want, np.asarray(Image.open(root / "jax_png" / "reference.png")).astype(np.int32))
    return root, files, want, enc


def _within_one(png_bytes_or_path, want):
    got = np.asarray(Image.open(png_bytes_or_path)).astype(np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("batch_size", [1, 8], ids=["decode_only", "batched"])
def test_reference_format_files_through_the_decompress_cli(torchac_files, batch_size):
    from sic_tpu_torch.cli.decompress import main
    root, files, want, _ = torchac_files
    out = root / f"port_png_{batch_size}"
    n = main(["--dataset_dir", str(files), "--save_dir", str(out),
              "--spec", "tiny", "--device", "cpu", "--batch_size", str(batch_size),
              "--ckpt_path", str(GOLDEN / "params.npz")])
    assert n == 2
    for stem in ("with_key", "reference"):
        _within_one(out / f"{stem}.png", want)


def test_reference_format_file_through_the_service(torchac_files):
    import io
    from sic_tpu_torch.service import ServiceState
    root, files, want, _ = torchac_files
    state = ServiceState("tiny", ckpt_path=str(GOLDEN / "params.npz"),
                         preview_cache=root / "previews", index_dir=root,
                         media_root=root, device="cpu")
    try:
        (name, png), = state.decompress_bytes(
            "reference.c2df", (files / "reference.c2df").read_bytes())
    finally:
        state.close()
    assert name == "reference.png"
    _within_one(io.BytesIO(png), want)


def test_port_writes_the_jax_torchac_z_stream(torchac_files):
    from sic_tpu_torch import config as tcfg
    from sic_tpu_torch.cli._common import load_runtime
    _, _, _, jenc = torchac_files
    rt = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(), device="cpu",
                      stream_part=4, z_format="torchac")
    try:
        enc = rt.encode_only(_golden_input()[None])
    finally:
        rt.close()
    assert enc["z_bit_stream"] == jenc["z_bit_stream"]
    assert enc["h_bit_stream"] == jenc["h_bit_stream"]
