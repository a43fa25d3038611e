"""The port's MaskGIT generator, its sampler and the generate CLI against
the JAX package's, on the CPU; and sequence attention at the head dims the
generator runs (48 at full width, 32 in the CLI's tiny spec).

Weights: the JAX modules' init, biases and norm parameters perturbed from
numpy, go into the port through ``weights.load_flax_params``.  Tolerances:
sequence attention and one attention layer 1e-5, the generator's logits
1e-4 (f32 summation order); the sampler's schedule and its token ids
exactly: at temperature 0 the sampler is deterministic, and at 4.5 the
port's ``_gumbel`` is patched to return the JAX sampler's own draws
(``jax.random.split`` as ``sic_tpu/models/maskgit.py:101`` splits).  The
generate CLIs' PNGs must be byte-equal, or differ by at most one level in
fewer than 1e-3 of their values.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sic_tpu_torch.weights import load_flax_params, load_npz
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from test_torch_titok import _perturbed, _tree, reference_state_dict

ATTN_TOL = 1e-5
LOGITS_TOL = 1e-4
# a 2-layer generator at head dim 48 (hidden 96, 2 heads), the full-width
# generator's head dim
SPEC = dict(codebook_size=64, condition_num_classes=10, image_seq_len=8,
            hidden=96, num_layers=2, num_heads=2)


def _jax_init(model, L):
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1,), bool))


@pytest.fixture(scope="module")
def generators():
    """The JAX generator, its perturbed leaves, and the port's twin."""
    from sic_tpu.models.maskgit import MaskGITGenerator as JGen
    from sic_tpu.models.maskgit import MaskGITSpec as JSpec
    from sic_tpu_torch.models.maskgit import MaskGITGenerator, MaskGITSpec
    jm = JGen(JSpec(**SPEC))
    flat = _perturbed(_jax_init(jm, SPEC["image_seq_len"]), 1)
    m = MaskGITGenerator(MaskGITSpec(**SPEC))
    assert not load_flax_params(m, flat)
    return jm, flat, m.eval()


# -- kernel 1's function at head dims 32 and 48 --------------------------------

@pytest.mark.parametrize("B,S,C,heads", [(2, 9, 64, 2), (2, 33, 96, 2),
                                         (3, 17, 192, 4)])
def test_seq_attention_plain_at_head_dims_32_and_48(B, S, C, heads):
    """The port's plain version (the CUDA kernel's oracle and its CPU path)
    against the JAX package's reference and its Pallas kernel in interpret
    mode: d = 32 (the tiny generator), 48 (MaskGIT at full width)."""
    from sic_tpu.ops.seq_attention import _seq_attn_pallas, _seq_attn_reference
    from sic_tpu_torch.ops import seq_attention, seq_attention_plain
    qkv = np.random.default_rng(S).standard_normal((B, S, 3 * C)).astype(np.float32)
    scale = (C // heads) ** -0.5
    got = seq_attention_plain(torch.from_numpy(qkv), scale, heads).numpy()
    for ref in (_seq_attn_reference(jnp.asarray(qkv), scale, heads),
                _seq_attn_pallas(jnp.asarray(qkv), scale, heads, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=ATTN_TOL, atol=ATTN_TOL)
    # a CPU tensor takes the plain version, whatever the head dim
    assert torch.equal(seq_attention(torch.from_numpy(qkv), scale, heads),
                       torch.from_numpy(got))


def test_multihead_self_attention_at_head_dim_48():
    from sic_tpu.models.layers import MultiheadSelfAttention as JAttn
    from sic_tpu_torch.models.layers import MultiheadSelfAttention
    x = np.random.default_rng(2).standard_normal((2, 33, 96)).astype(np.float32)
    jm = JAttn(2)
    flat = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4)
    m = MultiheadSelfAttention(96, 2)
    assert not load_flax_params(m, flat)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(_tree(flat), jnp.asarray(x))),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("d,dtype,takes", [
    (32, torch.float32, True), (48, torch.float32, True), (64, torch.float32, True),
    (32, torch.bfloat16, True), (48, torch.bfloat16, True), (64, torch.bfloat16, True),
    (42, torch.float32, False), (96, torch.float32, False), (36, torch.bfloat16, False),
    (80, torch.bfloat16, False)])
def test_kernel_head_dim_rule(d, dtype, takes):
    """The kernel takes d <= 64 with a row of d elements a multiple of 16
    bytes; on a CUDA tensor the wrapper refuses any other head dim before
    it launches (stand-in tensors: the check runs without a card;
    tests/test_torch_gpu.py launches on one)."""
    import importlib
    sa = importlib.import_module("sic_tpu_torch.ops.seq_attention")
    assert sa.kernel_takes_head_dim(d, dtype) == takes
    if takes:
        return
    fake = types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=(2, 33, 3 * 2 * d), is_contiguous=lambda: True)
    before = sa.seq_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        sa._forward_kernel(fake, d ** -0.5, 2)
    assert sa.seq_attention.launches == before


# -- the generator and its sampler ---------------------------------------------

def test_generator_logits(generators):
    """Conditioned and class-dropped logits within 1e-4, some positions
    masked."""
    jm, flat, m = generators
    rng = np.random.default_rng(5)
    ids = rng.integers(0, SPEC["codebook_size"] + 1, (3, 8)).astype(np.int32)
    cond = np.array([0, 3, 9], np.int32)
    drop = np.array([False, True, False])
    ref = jm.apply(_tree(flat), jnp.asarray(ids), jnp.asarray(cond), jnp.asarray(drop))
    got = m(torch.from_numpy(ids).long(), torch.from_numpy(cond).long(),
            torch.from_numpy(drop))
    assert got.shape == (3, 8, SPEC["codebook_size"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def _jax_schedule(step, num_sample_steps, L, randomize_temperature):
    """The JAX sampler's schedule lines (sic_tpu/models/maskgit.py:102-121),
    under jit with a traced step as in its fori_loop."""
    import math

    def f(step):
        ratio = (step + 1).astype(jnp.float32) / num_sample_steps
        temp = randomize_temperature * (1.0 - ratio)
        mask_ratio = jnp.arccos(ratio) / (math.pi * 0.5)
        return temp, jnp.floor(L * mask_ratio)
    return jax.jit(f)(jnp.int32(step))


@pytest.mark.parametrize("L", [8, 32])
@pytest.mark.parametrize("steps", [4, 8, 12])
def test_step_schedule_equals_the_jax_samplers(L, steps):
    from sic_tpu_torch.models.maskgit import step_schedule
    for step in range(steps):
        temp, mask_len = step_schedule(step, steps, L, 4.5)
        jtemp, jlen = _jax_schedule(step, steps, L, 4.5)
        assert temp.dtype == torch.float32
        assert temp.item() == float(jtemp) and mask_len == float(jlen), (step, steps, L)


def _generate_both(generators, cond, temperature, monkeypatch=None, steps=4):
    from sic_tpu.models import maskgit as jmaskgit
    from sic_tpu_torch.models import maskgit
    jm, flat, m = generators
    key = jax.random.PRNGKey(7)
    ref = jmaskgit.generate(jm, _tree(flat), key, jnp.asarray(cond),
                            guidance_scale=3.0, randomize_temperature=temperature,
                            num_sample_steps=steps)
    if monkeypatch is not None:
        B, L, K = len(cond), SPEC["image_seq_len"], SPEC["codebook_size"]
        draws = []
        for _ in range(steps):
            key, r1, r2 = jax.random.split(key, 3)
            draws += [np.asarray(jmaskgit._gumbel(r1, (B, L, K))),
                      np.asarray(jmaskgit._gumbel(r2, (B, L)))]

        def jax_draws(generator, shape):
            d = draws.pop(0)
            assert tuple(shape) == d.shape
            return torch.from_numpy(d)
        monkeypatch.setattr(maskgit, "_gumbel", jax_draws)
    got = maskgit.generate(m, torch.Generator().manual_seed(0),
                           torch.from_numpy(cond).long(), guidance_scale=3.0,
                           randomize_temperature=temperature, num_sample_steps=steps)
    if monkeypatch is not None:
        assert not draws
    return got.numpy(), np.asarray(ref)


def test_generate_ids_equal_the_jax_samplers_at_temperature_0(generators):
    got, ref = _generate_both(generators, np.array([1, 4, 7], np.int32), 0.0)
    np.testing.assert_array_equal(got, ref)


def test_generate_ids_equal_the_jax_samplers_with_its_noise(generators, monkeypatch):
    """Temperature 4.5, the port fed the JAX sampler's gumbel draws."""
    got, ref = _generate_both(generators, np.array([2, 5, 8], np.int32), 4.5,
                              monkeypatch)
    np.testing.assert_array_equal(got, ref)


def test_generate_ids_are_valid_and_seeded(generators):
    """Ids in [0, codebook_size), no mask id left, equal for one generator
    seed, other for another."""
    from sic_tpu_torch.models.maskgit import generate
    m = generators[2]
    cond = torch.tensor([0, 3, 9, 9])

    def run(seed):
        return generate(m, torch.Generator().manual_seed(seed), cond,
                        num_sample_steps=6)
    ids = run(11)
    assert ids.shape == (4, SPEC["image_seq_len"]) and ids.dtype == torch.long
    assert int(ids.min()) >= 0 and int(ids.max()) < SPEC["codebook_size"]
    assert not (ids == m.spec.mask_token_id).any()
    assert torch.equal(ids, run(11))
    assert not torch.equal(ids, run(12))


def test_seeded_generator_positions_draw_as_flax_does():
    """init_seeded draws MaskGIT's positional embedding N(0, 0.02), as
    flax's initializer, and the token embedding N(0, 0.02)."""
    from sic_tpu_torch.models.maskgit import MaskGITGenerator, MaskGITSpec
    from sic_tpu_torch.weights import init_seeded
    m = MaskGITGenerator(MaskGITSpec(**dict(SPEC, image_seq_len=255)))
    init_seeded(m, seed=3)
    for p in (m.positional_embedding, m.token_embedding.embedding):
        assert 0.018 < float(p.std()) < 0.022


# -- the converter and the CLI -------------------------------------------------

@pytest.fixture(scope="module")
def cli_generator(tmp_path_factory):
    """The generate CLI's tiny generator: the JAX init as a flax-msgpack
    file, and the npz that ``tools/convert_params.py maskgit-to-npz`` makes
    of it."""
    import flax.serialization

    from sic_tpu.models.maskgit import MaskGITGenerator as JGen
    from sic_tpu.models.maskgit import MaskGITSpec as JSpec
    from sic_tpu_torch.cli.generate import generator_spec, titok_specs
    from tools.convert_params import main as convert
    spec = generator_spec(titok_specs(tiny=True)[0], tiny=True)
    jm = JGen(JSpec(**dataclasses.asdict(spec)))
    flat = _perturbed(_jax_init(jm, spec.image_seq_len), 6)
    d = tmp_path_factory.mktemp("maskgit")
    src, dst = d / "gen.msgpack", d / "gen.npz"
    src.write_bytes(flax.serialization.to_bytes(_tree(flat)))
    assert convert(["maskgit-to-npz", str(src), str(dst)]) == 0
    return jm, flat, spec, src, dst


def test_converter_msgpack_to_npz(cli_generator):
    """Every leaf of the npz fits the port's generator, whose logits equal
    the JAX ones within 1e-4."""
    from sic_tpu_torch.models.maskgit import MaskGITGenerator
    jm, flat, spec, _, npz = cli_generator
    m = MaskGITGenerator(spec)
    assert not load_npz(m, npz)
    ids = np.random.default_rng(8).integers(0, spec.codebook_size + 1,
                                            (2, spec.image_seq_len)).astype(np.int32)
    cond, drop = np.array([1, 2], np.int32), np.array([False, True])
    ref = jm.apply(_tree(flat), jnp.asarray(ids), jnp.asarray(cond), jnp.asarray(drop))
    got = m.eval()(torch.from_numpy(ids).long(), torch.from_numpy(cond).long(),
                   torch.from_numpy(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_generate_cli_matches_the_jax_cli(cli_generator, tmp_path, monkeypatch):
    """Both CLIs, --tiny --temperature 0, on one TiTok reference-format
    .bin (seeded port weights mapped to the reference's names) and one
    generator (the msgpack for JAX, its converted npz for the port).

    The JAX CLI hands the torch tensors of the .bin to ``port_titok``,
    whose transposes are numpy's, and ports the full pixel decoder's depth
    whatever --tiny says; the test's shim gives it the numpy arrays and the
    tiny depth, which is what the port's CLI reads."""
    from PIL import Image

    import sic_tpu.port as jport
    from sic_tpu.cli import generate as jcli
    from sic_tpu_torch.cli import generate as cli
    from sic_tpu_torch.models.titok import TiTok
    from sic_tpu_torch.weights import export_flax_params, init_seeded
    ts, pix = cli.titok_specs(tiny=True)
    titok = TiTok(ts, pix)
    init_seeded(titok, seed=5)
    sd = reference_state_dict(export_flax_params(titok))
    bin_path = tmp_path / "titok.bin"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, bin_path)

    port_titok = jport.port_titok
    monkeypatch.setattr(jport, "port_titok", lambda sd, num_layers: port_titok(
        {k: v.numpy() for k, v in sd.items()}, num_layers,
        num_resolutions=pix.num_resolutions, num_res_blocks=pix.num_res_blocks))
    _, _, _, msgpack, npz = cli_generator
    common = ["--tiny", "--temperature", "0", "--classes", "0,3,7", "--steps", "6",
              "--titok_ckpt", str(bin_path)]
    want = jcli.main(common + ["--save_dir", str(tmp_path / "jax"),
                               "--maskgit_ckpt", str(msgpack)])
    got = cli.main(common + ["--save_dir", str(tmp_path / "port"),
                             "--maskgit_ckpt", str(npz), "--device", "cpu"])
    assert got == want == ["sample_class0_0.png", "sample_class3_1.png",
                           "sample_class7_2.png"]
    for name in got:
        a = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1 and np.mean(a != b) < 1e-3, name
