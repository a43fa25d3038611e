"""The work of one image, worked out from the configuration's shapes on
the reference's modules on PyTorch's meta device (shapes only, nothing
computed): model FLOPs by ``torch.utils.flop_counter`` (matrix products,
convolutions, attention's two products) and the attention calls'
shapes, which ``peaks.attention_least_s`` turns into a least time.  The
entropy chain and the host's work add no FLOPs."""
from __future__ import annotations

import torch


def count(fn):
    """(FLOPs, attention records) of ``fn()``."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..reference import attention
    attention.ATTENTION_CALLS = []
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops()), list(attention.ATTENTION_CALLS)
    finally:
        attention.ATTENTION_CALLS = None


def _dtype_name(run) -> str:
    return "float32" if run.tiny else run.config["compute_dtype"]


def _meta_codec(run):
    from ..drivers._codec import reference_spec
    from ..reference.codec import Codec
    with torch.device("meta"):
        return Codec(reference_spec(run)).eval().requires_grad_(False)


def _image_hw(run):
    t = run.traffic
    return tuple(t["rehearsal_hw"] if run.tiny else t["image_hw"])


@torch.no_grad()
def _latents(m, hw):
    x = torch.zeros((1,) + tuple(hw) + (3,), device="meta")
    z, h, stack = m.encode_stage(x)
    return x, z, h, stack


def _chain(bn, h):
    """The coding chain of one image: prior, three spatial steps, the
    synthesis transform (the encode side adds the analysis transform)."""
    B, H, W, _ = h.shape
    y = torch.zeros((B, H, W, bn.quant_dim), device="meta")
    common = bn.prior_params((B, H, W))
    red = bn.reduce_common(common)
    for step in (1, 2, 3):
        bn.spatial_step(step, y, red)
    bn.decode_transform(y)


@torch.no_grad()
def codec_decode_counts(run):
    m = _meta_codec(run)
    _x, z, h, stack = _latents(m, _image_hw(run))

    def work():
        _chain(m.hybrid_codec.quantize_feat, h)
        m.decode_stage(z, h, stack)

    flops, attn = count(work)
    return flops, attn, _dtype_name(run)


@torch.no_grad()
def codec_encode_counts(run, clip_fn=None):
    m = _meta_codec(run)
    x, _z, h, _stack = _latents(m, _image_hw(run))

    def work():
        _z2, h2, _s = m.encode_stage(x)
        m.hybrid_codec.quantize_feat.encode_transform(h2)
        _chain(m.hybrid_codec.quantize_feat, h2)
        if clip_fn is not None:
            clip_fn()

    flops, attn = count(work)
    return flops, attn, _dtype_name(run)


@torch.no_grad()
def generate_counts(run, sampling):
    """One image of a generate batch: the generator's forward at each step
    (twice under guidance), then TiTok's token decode."""
    from ..drivers.generate import _specs
    from ..reference import config as rc, maskgit as rm, maskgit_vqgan as rv, titok as rt
    ts, ps, gs = _specs(run, rc, rv, rm)
    with torch.device("meta"):
        titok = rt.TiTok(ts, ps).eval().requires_grad_(False)
        gen = rm.MaskGITGenerator(gs).eval().requires_grad_(False)
    ids = torch.zeros((1, gs.image_seq_len), dtype=torch.long, device="meta")
    cond = torch.zeros((1,), dtype=torch.long, device="meta")
    drop = torch.zeros((1,), dtype=torch.bool, device="meta")
    passes = int(sampling["num_sample_steps"]) * (2 if sampling["guidance_scale"] else 1)

    def work():
        for _ in range(passes):
            gen(ids, cond, drop)
        titok.decode_tokens(ids)

    flops, attn = count(work)
    return flops, attn, _dtype_name(run)
