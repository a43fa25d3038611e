"""Model specs and presets of the PyTorch port.

Plain dataclasses with the same fields and defaults as the JAX package's
``CodecSpec`` / ``TiTokSpec`` / ``VQGANSpec`` and its three presets, so one
spec names the same geometry in both packages.  The reference-YAML loader and
the training presets are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

_VIT_SIZES = {"tiny": (128, 2, 2),  # test-scale, not in the reference table
              "small": (512, 8, 8), "base": (768, 12, 12),
              "large": (1024, 24, 16)}


@dataclasses.dataclass(frozen=True)
class TiTokSpec:
    """TiTok ViT geometry (reference: config_test.yaml:20-34)."""
    model_size: str = "large"
    patch_size: int = 16
    num_latent_tokens: int = 32
    token_size: int = 12
    codebook_size: int = 4096
    commitment_cost: float = 0.25
    use_l2_norm: bool = True
    tile_px: int = 256

    @property
    def width(self) -> int:
        return _VIT_SIZES[self.model_size][0]

    @property
    def num_layers(self) -> int:
        return _VIT_SIZES[self.model_size][1]

    @property
    def num_heads(self) -> int:
        return _VIT_SIZES[self.model_size][2]

    @property
    def grid_size(self) -> int:
        return self.tile_px // self.patch_size


@dataclasses.dataclass(frozen=True)
class VQGANSpec:
    """VQGAN ddconfig (reference: config_test.yaml:43-54)."""
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 256
    resolution: int = 256
    embed_dim: int = 256
    n_embed: int = 256
    use_attn: bool = True
    dropout: float = 0.0

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.num_resolutions - 1)


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Full-model hyperparameters (reference: config_test.yaml)."""
    titok: TiTokSpec = TiTokSpec()
    vqgan: VQGANSpec = VQGANSpec()
    feat_width: int = 768
    quant_dim: int = 64
    insert_pos_enc: Tuple[int, ...] = (3, 7, 11, 15, 19)
    insert_pos_dec: Tuple[int, ...] = (3, 7, 11, 15, 19)
    num_attns: int = 2
    merge_inner_width: int = 1024
    remat: bool = False
    force_zero_thres: float = 0.12

    @property
    def tile_px(self) -> int:
        return self.titok.tile_px


def flagship_spec(**overrides) -> CodecSpec:
    """The shipped model: TiTok-L trunks, 768-wide detail branch."""
    return dataclasses.replace(CodecSpec(), **overrides)


def small_spec(**overrides) -> CodecSpec:
    """Mid-scale spec: ViT-small trunk, half-width VQGAN, 384-ch detail."""
    base = CodecSpec(
        titok=TiTokSpec(model_size="small", codebook_size=1024,
                        token_size=12, num_latent_tokens=32),
        vqgan=VQGANSpec(ch=64, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=1,
                        attn_resolutions=(16,), z_channels=128,
                        embed_dim=128, n_embed=512, resolution=256),
        feat_width=384, quant_dim=48, merge_inner_width=512,
        insert_pos_enc=(1, 3, 5, 7), insert_pos_dec=(1, 3, 5, 7))
    return dataclasses.replace(base, **overrides)


def tiny_spec(**overrides) -> CodecSpec:
    """Test-scale spec (CPU-friendly); same topology, tiny widths."""
    base = CodecSpec(
        titok=TiTokSpec(model_size="tiny", codebook_size=64, token_size=8,
                        num_latent_tokens=8),
        vqgan=VQGANSpec(ch=32, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=1,
                        attn_resolutions=(16,), z_channels=64, embed_dim=64,
                        n_embed=64, resolution=256),
        feat_width=64, quant_dim=16, merge_inner_width=128)
    return dataclasses.replace(base, **overrides)
