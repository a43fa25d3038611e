"""Model specs: plain dataclasses with the fields and defaults of the
codec's ``CodecSpec`` / ``TiTokSpec`` / ``VQGANSpec``, filled from a
configuration file's ``spec``.
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
