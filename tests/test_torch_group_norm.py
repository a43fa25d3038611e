"""The fused GroupNorm + SiLU of the port on the CPU: the plain version
against the composite ops the modules ran before it, the rules that choose
a path, the wrapper's chunking, and the VQGAN modules that set the SiLU
flag.  The kernel itself runs only on the card (``tests/test_torch_gpu.py``).

In f32 the plain version is the composite ops bit for bit (the same
``F.group_norm``, SiLU in f32).  In bf16 it rounds once where the
composite ops rounded the norm's output y and then SiLU's: the two differ
by at most one bf16 ulp of the output plus SiLU's slope (at most 1.1)
times the half ulp of y that the first rounding moved (for y < 0 SiLU's
output is smaller than y, so that half ulp of y can be more than an ulp
of the output).
"""
import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sic_tpu_torch import config as tcfg
from sic_tpu_torch import ops
from sic_tpu_torch.models import layers
from sic_tpu_torch.models.layers import GroupNorm
from sic_tpu_torch.ops.group_norm import (DTYPES, MAX_CHUNKS, THREADS, chunking,
                                          group_norm_nhwc_plain, kernel_takes)

BF16 = torch.bfloat16


def _composite(x, weight, bias, groups, eps, silu):
    """The modules' GroupNorm, then their separate SiLU, as they ran before
    the fused kernel: the norm's output rounded to x's dtype, SiLU on it."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), groups, weight.float(),
                     bias.float(), eps).permute(0, 2, 3, 1).to(x.dtype)
    return F.silu(y) if silu else y


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def _norm(C, seed, silu=True):
    g = torch.Generator().manual_seed(seed)
    m = GroupNorm(32, C, eps=1e-6, silu=silu)
    with torch.no_grad():
        m.weight.copy_(1 + 0.5 * torch.randn(C, generator=g))
        m.bias.copy_(0.5 * torch.randn(C, generator=g))
    return m


def _input(shape, seed, dtype=torch.float32):
    """Off zero mean, a different offset a channel."""
    rng = np.random.default_rng(seed)
    x = 2 * rng.standard_normal(shape) + 3 * rng.standard_normal(shape[-1])
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("C", [128, 256, 512])   # C / G = 4, 8, 16
def test_plain_against_the_composite_ops(C, dtype, silu):
    m = _norm(C, C, silu).requires_grad_(False)
    x = _input((2, 6, 5, C), C, dtype)
    want = _composite(x, m.weight, m.bias, 32, 1e-6, silu)
    got = group_norm_nhwc_plain(x, m.weight, m.bias, 32, 1e-6, silu)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32 or not silu:
        assert torch.equal(got, want)
    else:
        y = group_norm_nhwc_plain(x.float(), m.weight, m.bias, 32, 1e-6)
        got, want = got.float(), want.float()
        tol = _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 0.55 * _bf16_ulp(y)
        assert bool(((got - want).abs() <= tol).all())
        assert not torch.equal(got, want)     # the rounding did move


def test_module_on_the_cpu_takes_the_plain_version():
    """No grad recorded (grad mode off, or nothing requiring grad): the
    plain version, nothing counted."""
    m = _norm(128, 1)
    x = _input((2, 4, 4, 128), 1, BF16)
    ops.reset_launch_counts()
    with torch.no_grad():
        a = m(x)
    m.requires_grad_(False)
    b = m(x)
    assert ops.group_norm_counts() == {"launches": 0, "composite": 0}
    want = group_norm_nhwc_plain(x, m.weight, m.bias, 32, 1e-6, True)
    assert torch.equal(a, want) and torch.equal(b, want)


@pytest.mark.parametrize("needs_grad", ["input", "weight"])
def test_module_under_autograd_runs_the_composite_ops(needs_grad):
    """Grad mode on and the input or a parameter requiring grad (the pix
    stage's training): the plain version's composite ops, counted, the
    same function as without grad, and the input's gradient flows.  (The
    CPU's channels-last GroupNorm backward with only the weight requiring
    grad crashes in torch 2.13, before and after this path: the weight's
    case checks no backward.)"""
    m = _norm(256, 2)
    x = _input((2, 4, 4, 256), 2, BF16)
    if needs_grad == "input":
        m.requires_grad_(False)
        x.requires_grad_(True)
    ops.reset_launch_counts()
    y = m(x)
    assert ops.group_norm_counts() == {"launches": 0, "composite": 1}
    with torch.no_grad():
        assert torch.equal(y, m(x))
    assert torch.equal(y, group_norm_nhwc_plain(x, m.weight, m.bias, 32, 1e-6, True))
    assert y.requires_grad
    if needs_grad == "input":
        y.float().sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()


def test_module_on_width_slabs_keeps_its_two_pass_statistics(monkeypatch):
    """Under a tile group the norm takes its statistics over the group
    (here a group of one rank: the sums are the slab's), counted as
    composite; SiLU follows."""
    monkeypatch.setattr(layers, "_norm_group", lambda: types.SimpleNamespace(size=1))
    monkeypatch.setattr(layers, "tile_sum", lambda t, group: t)
    m = _norm(128, 3)
    x = _input((1, 4, 6, 128), 3)
    ops.reset_launch_counts()
    with torch.no_grad():
        y = m(x)
    assert ops.group_norm_counts() == {"launches": 0, "composite": 1}
    torch.testing.assert_close(y, _composite(x, m.weight, m.bias, 32, 1e-6, True),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_a_tensor_off_the_cpu_and_the_card():
    m = _norm(128, 4)
    ops.reset_launch_counts()
    with pytest.raises(ValueError), torch.no_grad():
        m(torch.empty((1, 4, 4, 128), device="meta"))
    assert ops.group_norm_counts() == {"launches": 0, "composite": 0}


@pytest.mark.parametrize("B,HW,C,dtype", [
    (8, 512 * 512, 128, BF16), (8, 256 * 256, 128, BF16), (8, 128 * 128, 256, BF16),
    (8, 64 * 64, 256, BF16), (8, 32 * 32, 512, BF16), (1, 512 * 512, 128, BF16),
    (16, 256 * 256, 128, torch.float32), (16, 16 * 16, 512, torch.float32),
    (2, 8 * 8, 32, torch.float32), (1, 3, 64, BF16), (3, 7 * 5, 96, torch.float32)])
def test_chunking_covers_each_image_once(B, HW, C, dtype):
    """S chunks of P pixels, none empty, P a multiple of the pixels a
    block covers at once; no more than MAX_CHUNKS partials an image."""
    S, P = chunking(B, HW, C, dtype)
    rows = THREADS // (C // (16 // torch.empty((), dtype=dtype).element_size()))
    assert 1 <= S <= MAX_CHUNKS and P % rows == 0
    assert (S - 1) * P < HW <= S * P


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_takes_every_decoder_width(dtype):
    """The flagship's and MaskGIT-VQGAN's widths (C / G 4, 8, 16) and the
    tiny spec's (1, 2, 4); not groups that straddle a 16-byte vector."""
    for C in (32, 64, 128, 256, 512):
        assert kernel_takes(C, 32, dtype)
    assert not kernel_takes(96, 32, dtype)            # groups of 3
    assert not kernel_takes(128, 7, dtype)
    assert kernel_takes(96, 8, torch.float32) and not kernel_takes(96, 8, BF16)
    assert not kernel_takes(128, 32, torch.float16)


# -- the modules that set the flag ------------------------------------------------


def _legacy(monkeypatch):
    """The modules as they ran before the flag: every norm through the
    composite ops, SiLU on its output in the activation's dtype."""
    def forward(self, x):
        return _composite(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)
    monkeypatch.setattr(GroupNorm, "forward", forward)


@pytest.fixture(scope="module")
def decoder():
    from sic_tpu_torch.models.vqgan import VQGAN
    from sic_tpu_torch.weights import init_seeded
    m = VQGAN(tcfg.tiny_spec().vqgan)
    init_seeded(m, seed=5)
    z = _input((1, 4, 4, tcfg.tiny_spec().vqgan.embed_dim), 5)
    return m.eval().requires_grad_(False), z


def test_vqgan_decoder_and_return_pre_unchanged(decoder, monkeypatch):
    """The tiny VQGAN's decode (resnet blocks, attention, norm_out) and its
    pre-``conv_out`` activation (after SiLU) equal the legacy modules' bit
    for bit in f32; every norm but the attention blocks' has the flag."""
    m, z = decoder
    flags = [(n, g.silu) for n, g in m.decoder.named_modules() if isinstance(g, GroupNorm)]
    assert flags and all(s == ("attn" not in n) for n, s in flags)
    with torch.no_grad():
        got, pre = m.decode(z, return_pre=True)
        block = m.decoder.mid_block_1(m.decoder.conv_in(m.post_quant_conv(z)))
    _legacy(monkeypatch)
    with torch.no_grad():
        want, want_pre = m.decode(z, return_pre=True)
        want_block = m.decoder.mid_block_1(m.decoder.conv_in(m.post_quant_conv(z)))
    assert torch.equal(got, want) and torch.equal(pre, want_pre)
    assert torch.equal(block, want_block)
    assert float(pre.min()) >= -0.2785           # SiLU's least value


def test_maskgit_pixel_decoder_unchanged(monkeypatch):
    from sic_tpu_torch.models.maskgit_vqgan import MaskGITVQGANSpec, PixelDecoder
    from sic_tpu_torch.weights import init_seeded
    spec = MaskGITVQGANSpec(hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                            z_channels=8)
    m = PixelDecoder(spec)
    init_seeded(m, seed=6)
    m = m.eval().requires_grad_(False)
    z = _input((1, 4, 4, 8), 6)
    assert all(g.silu for g in m.modules() if isinstance(g, GroupNorm))
    with torch.no_grad():
        got = m(z)
    _legacy(monkeypatch)
    with torch.no_grad():
        want = m(z)
    assert torch.equal(got, want) and math.isfinite(float(got.abs().max()))
