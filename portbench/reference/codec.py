"""The flagship codec's networks in plain PyTorch (a copy of the port's
``Codec`` on one process, without its training forward) and the decode and
encode of whole images: the container's fields, the semantic stream (a
uniform CDF over the codebook), the detail stream's chain (``bottleneck``)
and the pixel decoder."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .bottleneck import CODING_BATCH, Chain
from .config import CodecSpec
from .hybrid import FeatMerge, HybridCodec
from .layers import set_compute_dtype
from .quantizer import _l2n
from .rans import StreamDecoder
from .vqgan import VQGAN


class Codec(nn.Module):
    """Hybrid codec + VQGAN + prior fusion; parameter names are the
    port's."""

    def __init__(self, spec: CodecSpec):
        super().__init__()
        s = spec
        self.spec = spec
        self.hybrid_codec = HybridCodec(s.titok, s.insert_pos_enc,
                                        s.insert_pos_dec, s.feat_width,
                                        s.quant_dim, s.num_attns)
        self.vqgan = VQGAN(s.vqgan)
        self.prior_fusion = FeatMerge(s.titok.width, s.feat_width,
                                      s.vqgan.n_embed, s.merge_inner_width)

    def compute_in(self, dtype: torch.dtype) -> "Codec":
        """The networks outside the bottleneck compute in ``dtype`` (their
        weights stay f32, cast on each call), as the port's bf16 mode sets
        them; the coding chain stays f32."""
        hc = self.hybrid_codec
        for m in (hc.encoder, hc.decoder, self.vqgan, self.prior_fusion):
            set_compute_dtype(m, dtype)
        return self

    def encode_stage(self, x01):
        """[0, 1] image (multiples of the tile) -> (z token indices
        (BT, n_latent), detail latent, stack_shape)."""
        hc = self.hybrid_codec
        z, h, stack_shape = hc.encoder(x01, hc.latent_tokens)
        return hc.quantize.encode_indices(z), h.float(), stack_shape

    def token_margins(self, x01) -> torch.Tensor:
        """Each token's margin between its nearest code and the next (the
        quantizer's score, ``2 z.c - |c|^2`` on unit vectors), (BT*n,)."""
        hc = self.hybrid_codec
        z, _h, _s = hc.encoder(x01, hc.latent_tokens)
        zf = z.float().reshape(-1, z.shape[-1])
        if hc.quantize.use_l2_norm:
            zf = _l2n(zf)
        cb = hc.quantize.codebook().float()
        scores = 2.0 * (zf @ cb.T) - torch.sum(cb * cb, dim=-1)[None, :]
        top = torch.topk(scores, 2, dim=-1).values
        return top[:, 0] - top[:, 1]

    def decode_to_latent(self, titok_hat, feat_hat):
        logits = self.prior_fusion(titok_hat, feat_hat)
        probs = torch.softmax(logits.float(), dim=-1)
        latent = torch.matmul(probs, self.vqgan.quantize.codebook())
        return latent.to(logits.dtype), logits

    def decode_stage(self, z_indices, h_hat, stack_shape):
        hc = self.hybrid_codec
        z_hat = hc.decode_z_indices(z_indices)
        titok_hat, feat_hat = hc.decoder(z_hat, h_hat, tuple(stack_shape))
        latent, _ = self.decode_to_latent(titok_hat, feat_hat)
        return torch.clamp(self.vqgan.decode(latent), -1.0, 1.0)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats -> uint8 pixels, truncating."""
    return torch.clamp((x + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


def z_tables(codebook_size: int, precision: int = 16):
    """The semantic stream's one uniform CDF row."""
    cdf = np.zeros(codebook_size + 1, np.int64)
    cdf[1:] = np.cumsum(np.full(codebook_size, (1 << precision) // codebook_size))
    cdf[-1] = 1 << precision
    return [cdf], [codebook_size + 1], [0]


def decode_z(stream: bytes, token_length: int, codebook_size: int):
    """-> (ids, substreams left unfinished)."""
    dec = StreamDecoder(stream, *z_tables(codebook_size))
    ids = dec.decode(np.zeros(int(token_length), np.int64))
    return ids, dec.unfinished()


class Decoder:
    """Streams of one shape -> pixels, layer by layer: the semantic ids,
    the detail chain's symbols and h_hat, and the pixel decoder in blocks
    of ``block`` images."""

    def __init__(self, model: Codec):
        self.model = model
        self.chain = Chain(model.hybrid_codec.quantize_feat,
                           force_zero_thres=model.spec.force_zero_thres)
        self.desynced = 0      # substreams the last decode left unfinished

    @torch.no_grad()
    def decode(self, encs, block: int = 4):
        """``encs``: dicts of container fields (``z_bit_stream``,
        ``h_bit_stream``, ``token_length``, ``z_indices_shape``,
        ``feat_shape`` (B, H, W, C), ``stack_shape``, ``coding_batch``)
        of one shape.  Returns (u8 pixels (B, H, W, 3) on the CPU, z ids
        (B*T, n), detail symbol planes)."""
        spec = self.model.spec
        dev = self.model.hybrid_codec.quantize_feat.factorized_prior_vec.device
        first = encs[0]
        n_latent = int(first["z_indices_shape"][-1])
        zs = [decode_z(e["z_bit_stream"], e["token_length"],
                       spec.titok.codebook_size) for e in encs]
        z = np.concatenate([ids for ids, _ in zs]).reshape(-1, n_latent)
        self.desynced = sum(bad for _, bad in zs)
        fs = [int(v) for v in first["feat_shape"]]
        h_hat, planes, bad = self.chain.decode(
            [e["h_bit_stream"] for e in encs], (fs[1], fs[2]),
            int(first.get("coding_batch") or CODING_BATCH))
        self.desynced += bad
        self.latents = (z, h_hat, tuple(first["stack_shape"]))
        return self.pixels(block), z, planes

    @torch.no_grad()
    def pixels(self, block: int = 4) -> torch.Tensor:
        """The pixel decoder on the last decode's latents, in blocks."""
        z, h_hat, stack = self.latents
        dev = h_hat.device
        nt = z.shape[0] // h_hat.shape[0]
        out = []
        for b in range(0, h_hat.shape[0], block):
            e = min(h_hat.shape[0], b + block)
            zb = torch.from_numpy(z[b * nt:e * nt]).to(dev)
            out.append(to_u8(self.model.decode_stage(zb, h_hat[b:e], stack)).cpu())
        return torch.cat(out)
