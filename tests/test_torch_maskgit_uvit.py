"""The port's U-ViT generator (``models/maskgit_uvit.py``), the sampler's
guidance schedules and the generate CLI's ``--model titok_s128``, on the
CPU, against the benchmark's plain reference
``portbench/reference/maskgit_uvit.py``.

Weights: one seeded draw (``portbench/harness/weights.py``), its biases
and norm parameters then perturbed (the draw zeroes biases and fixes
norms at 1 and 0, under which a bias or skip-order fault would hide).
Tolerances: logits 1e-4 (f32 summation order); the guidance factor, the
softmax temperature and the sampler's token ids exactly, since both
sides compute them in the same float32 steps on the CPU and the CPU
forward passes agree to the bit.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness.weights import init_seeded as harness_init
from portbench.reference import maskgit_uvit as ref
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

LOGITS_TOL = 1e-4
# two in blocks (so the skips' order shows), a mid block, two out blocks;
# head dim 48 as the port's other generator at full width
SPEC = dict(codebook_size=64, condition_num_classes=10, image_seq_len=8,
            hidden=96, num_layers=4, num_heads=2, intermediate_size=192)
POWER_COSINE = dict(guidance_scale=6.9, guidance_decay="power-cosine",
                    softmax_temperature_annealing=True)
CONFIGS = Path(__file__).resolve().parents[1] / "portbench" / "configs"


def _perturb(model, seed):
    """Biases and norm parameters off their seeded 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ".ln_" in name or name.startswith("ln_"):
                p.add_(0.2 * torch.randn(p.shape, generator=g))


@pytest.fixture(scope="module")
def models():
    """The port's generator, seeded and perturbed, and the reference with
    the same state."""
    from sic_tpu_torch.models.maskgit_uvit import UViTGenerator, UViTSpec
    m = UViTGenerator(UViTSpec(**SPEC)).eval()
    harness_init(m, 11)
    _perturb(m, 12)
    r = ref.UViTGenerator(ref.UViTSpec(**SPEC)).eval()
    r.load_state_dict(m.state_dict())
    return m, r


def _inputs(seed, B=3):
    g = np.random.default_rng(seed)
    ids = torch.from_numpy(g.integers(0, SPEC["codebook_size"] + 1, (B, SPEC["image_seq_len"])))
    cond = torch.from_numpy(g.integers(0, SPEC["condition_num_classes"], B))
    drop = torch.from_numpy(g.integers(0, 2, B).astype(bool))
    return ids, cond, drop


def test_names_and_order_fit_both_seeded_initialisations():
    """The port's and the reference's parameters carry the same names in the
    same order, so the benchmark's draw fills both alike, and the port's own
    ``weights.init_seeded`` draws what the benchmark's does; the three
    embedding tables draw N(0, 0.02)."""
    from sic_tpu_torch.models.maskgit_uvit import UViTGenerator, UViTSpec
    from sic_tpu_torch.weights import init_seeded
    m = UViTGenerator(UViTSpec(**dict(SPEC, image_seq_len=255)))
    r = ref.UViTGenerator(ref.UViTSpec(**dict(SPEC, image_seq_len=255)))
    assert [n for n, _ in m.named_parameters()] == [n for n, _ in r.named_parameters()]
    harness_init(m, 5)
    harness_init(r, 5)
    mine = UViTGenerator(UViTSpec(**dict(SPEC, image_seq_len=255)))
    init_seeded(mine, 5)
    for (name, a), b, c in zip(m.state_dict().items(), r.state_dict().values(),
                               mine.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c), name
    blocks = [*m.in_blocks, m.mid_block, *m.out_blocks]
    assert all(b.attn.in_proj.bias is None for b in blocks)
    assert [b.skip_linear is not None for b in blocks] == [False] * 3 + [True] * 2
    for p in (m.position_embedding, m.token_embedding.embedding):
        assert 0.018 < float(p.detach().std()) < 0.022


def test_logits_match_the_reference(models):
    """Conditioned and class-dropped rows, some positions masked, within
    1e-4 of the reference."""
    m, r = models
    ids, cond, drop = _inputs(1)
    with torch.no_grad():
        got, want = m(ids, cond, drop), r(ids, cond, drop)
    assert got.shape == (3, SPEC["image_seq_len"], SPEC["codebook_size"])
    assert (got - want).abs().max() <= LOGITS_TOL
    # the skips matter: reversing their order moves the logits
    with torch.no_grad():
        r.out_blocks = torch.nn.ModuleList(r.out_blocks[::-1])
        try:
            assert (r(ids, cond, drop) - want).abs().max() > 100 * LOGITS_TOL
        finally:
            r.out_blocks = torch.nn.ModuleList(r.out_blocks[::-1])


@pytest.mark.parametrize("n", [8, 12, 64, 256])
def test_power_cosine_factor_equals_the_reference(n):
    """Every step's guidance factor and annealed softmax temperature equal
    the reference's exactly; the factor is 1 at step 0 and rises towards
    the scale as (1 - cos(pi (step / n) ** 3)) / 2 does in float64."""
    from sic_tpu_torch.models.maskgit import (GUIDANCE_SCALE_POW, guidance_cfg,
                                              softmax_temperature)
    assert GUIDANCE_SCALE_POW == ref.GUIDANCE_SCALE_POW == 3.0
    prev = 0.0
    for step in range(n):
        cfg = guidance_cfg(step, n, 6.9)
        assert cfg == ref.guidance_cfg(step, n, 6.9)
        assert softmax_temperature(step, n) == ref.softmax_temperature(step, n)
        exact = 5.9 * (1 - np.cos(np.pi * (step / n) ** 3)) / 2 + 1
        assert cfg == pytest.approx(exact, rel=1e-6) and cfg >= prev
        prev = cfg
    assert guidance_cfg(0, n, 6.9) == 1.0


@pytest.mark.parametrize("temperature", [0.0, 2.8])
def test_sampler_ids_equal_the_reference_samplers(models, temperature):
    """Power-cosine guidance with softmax-temperature annealing, 12 steps:
    at temperature 0, and at 2.8 with both samplers drawing their Gumbel
    noise from generators of one seed (the same draws, in the same order)."""
    from sic_tpu_torch.models.maskgit import generate
    m, r = models
    cond = torch.tensor([0, 4, 9, 2])
    kw = dict(POWER_COSINE, randomize_temperature=temperature, num_sample_steps=12)
    got = generate(m, torch.Generator().manual_seed(3), cond, **kw)
    want = ref.generate(r, torch.Generator().manual_seed(3), cond, **kw)
    assert torch.equal(got, want)
    assert int(got.min()) >= 0 and int(got.max()) < SPEC["codebook_size"]


def test_default_sampler_path_is_unchanged():
    """``generate``'s defaults (constant guidance 3.0, temperature 4.5, 8
    steps) and guidance off give the ids the sampler gave before the
    guidance schedules came in, for one seeded tiny MaskGIT generator."""
    from sic_tpu_torch.models.maskgit import MaskGITGenerator, MaskGITSpec, generate
    from sic_tpu_torch.weights import init_seeded
    m = MaskGITGenerator(MaskGITSpec(codebook_size=64, condition_num_classes=10,
                                     image_seq_len=8, hidden=64, num_layers=2,
                                     num_heads=2)).eval()
    init_seeded(m, seed=3)
    cond = torch.tensor([0, 3, 9, 5])
    ids = generate(m, torch.Generator().manual_seed(7), cond)
    assert ids.tolist() == [[8, 11, 4, 19, 24, 38, 23, 38], [2, 54, 1, 26, 60, 43, 40, 38],
                            [1, 17, 56, 4, 54, 38, 2, 63], [17, 13, 14, 47, 14, 63, 38, 38]]
    ids = generate(m, torch.Generator().manual_seed(7), cond, guidance_scale=0.0,
                   num_sample_steps=5)
    assert ids.tolist() == [[41, 25, 4, 38, 24, 38, 21, 38], [2, 54, 38, 38, 60, 43, 38, 58],
                            [17, 25, 24, 4, 43, 38, 2, 38], [38, 13, 63, 47, 38, 40, 38, 38]]
    with pytest.raises(ValueError, match="guidance_decay"):
        generate(m, torch.Generator(), cond, guidance_decay="linear")


def test_generate_cli_titok_s128_tiny(tmp_path):
    """``--model titok_s128 --tiny`` samples with the U-ViT (power-cosine,
    64 steps) and writes one PNG a class; checkpoints are refused."""
    from PIL import Image

    from sic_tpu_torch.cli import generate as cli
    names = cli.main(["--model", "titok_s128", "--tiny", "--device", "cpu",
                      "--classes", "0,7", "--steps", "6", "--save_dir", str(tmp_path)])
    assert names == ["sample_class0_0.png", "sample_class7_1.png"]
    for name in names:
        assert np.asarray(Image.open(tmp_path / name)).shape == (32, 32, 3)
    with pytest.raises(SystemExit):
        cli.main(["--model", "titok_s128", "--tiny", "--save_dir", str(tmp_path),
                  "--maskgit_ckpt", str(tmp_path / "gen.npz")])


@pytest.mark.parametrize("model,config", [("titok_l32", "titok-l32-maskgit"),
                                          ("titok_s128", "titok-s128-uvit")])
def test_generate_cli_samples_as_the_benchmark_configuration(monkeypatch, tmp_path,
                                                             model, config):
    """``--model`` hands the sampler exactly the ``sampling`` keys of the
    benchmark's configuration of that model (for ``titok_s128``: 64 steps,
    power-cosine 6.9, temperature 2.8, softmax-temperature annealing)."""
    from sic_tpu_torch.cli import generate as cli
    seen = []

    def sampler(gen, g, cond, **kw):
        seen.append(kw)
        return torch.zeros((cond.shape[0], gen.spec.image_seq_len), dtype=torch.long)

    monkeypatch.setattr(cli, "generate", sampler)
    cli.main(["--model", model, "--tiny", "--device", "cpu", "--save_dir", str(tmp_path)])
    want = json.loads((CONFIGS / f"{config}.json").read_text())["sampling"]
    assert seen == [want]
