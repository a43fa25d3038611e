"""Model specs and presets of the PyTorch port.

Plain dataclasses with the same fields and defaults as the JAX package's
``CodecSpec`` / ``TiTokSpec`` / ``VQGANSpec`` and its three presets, so one
spec names the same geometry in both packages, and the eight training rate
presets (:func:`qp_strategy`), and :func:`load_config`, which reads a
reference-layout YAML (``configs/*.yaml``) through the port's own YAML
reader (``config_yaml.py``) into a spec, a training strategy, loss configs
and ``tune_titok``, as the JAX package's ``load_config`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


# -- training presets (reference: src/config/train/config_qp{0..3}_{256,512}train.yaml)

_S1_256 = (4.0, 4.78, 5.72, 6.85, 8.19, 9.8, 11.72, 14.02, 16.77, 20.06, 24.0, 26.0)

_QP_256 = {
    0: ((1.0, 4.0, 8.0, 9.24, 10.61, 12.19, 14.0, 16.08, 18.47, 21.22, 24.38, 28.0),
        (0.003, 0.008), (0.008, 0.015)),
    1: ((1.0, 4.0, 6.0, 8.26, 8.97, 9.74, 10.58, 11.5, 12.49, 13.56, 14.73, 16.0),
        (0.005, 0.010), (0.008, 0.015)),
    2: ((1.0, 4.0, 4.31, 4.65, 5.01, 5.41, 5.83, 6.29, 6.78, 7.31, 7.88, 8.5),
        (0.010, 0.015), (0.010, 0.015)),
    3: ((1.0, 4.0, 4.15, 4.31, 4.47, 4.64, 4.82, 5.0, 5.19, 5.38, 5.59, 5.8),
        (0.015, 0.020), (0.010, 0.015)),
}
_QP_512 = {0: (28.0, (0.001, 0.003)), 1: (16.0, (0.003, 0.010)),
           2: (8.5, (0.010, 0.015)), 3: (5.8, (0.015, 0.020))}


def qp_strategy(qp: int, train_px: int = 256):
    """The eight shipped rate presets (4 QPs x {256, 512} train size); the
    512-px presets start directly in stage pix."""
    from .train.strategy import StageSpec, TrainingStrategy
    if train_px == 256:
        s2_lams, s2_band, s1_band = _QP_256[qp]
        return TrainingStrategy(
            learning_rate=4e-5, start_epoch=0,
            stages=(StageSpec(1, 0, (1e-3,) * 12, 2.0, 0.001),
                    StageSpec(7, 0, _S1_256, s1_band[1], s1_band[0]),
                    StageSpec(90, 0, s2_lams, s2_band[1], s2_band[0])))
    if train_px == 512:
        lam, band = _QP_512[qp]
        return TrainingStrategy(
            learning_rate=2e-5, start_epoch=0,
            stages=(StageSpec(0, 0, (lam,), 2.0, 0.001),
                    StageSpec(0, 0, (lam,), 0.015, 0.008),
                    StageSpec(90, 0, (lam,), band[1], band[0])))
    raise ValueError(f"train_px must be 256 or 512, got {train_px}")


# -- reference-YAML ingestion ----------------------------------------------------

def _titok_from_yaml(cfg: Dict) -> TiTokSpec:
    vq = cfg["model"]["vq_model"]
    return TiTokSpec(
        model_size=vq.get("vit_enc_model_size", "large"),
        patch_size=int(vq.get("vit_enc_patch_size", 16)),
        num_latent_tokens=int(vq.get("num_latent_tokens", 32)),
        token_size=int(vq.get("token_size", 12)),
        codebook_size=int(vq.get("codebook_size", 4096)),
        commitment_cost=float(vq.get("commitment_cost", 0.25)),
        use_l2_norm=bool(vq.get("use_l2_norm", True)),
        tile_px=int(cfg.get("dataset", {}).get("preprocessing", {})
                    .get("crop_size", 256)))


def _vqgan_from_yaml(cfg: Dict) -> VQGANSpec:
    dd = cfg["ddconfig"]
    return VQGANSpec(
        ch=int(dd["ch"]), ch_mult=tuple(dd["ch_mult"]),
        num_res_blocks=int(dd["num_res_blocks"]),
        attn_resolutions=tuple(dd["attn_resolutions"]),
        in_channels=int(dd["in_channels"]), out_ch=int(dd["out_ch"]),
        z_channels=int(dd["z_channels"]), resolution=int(dd["resolution"]),
        embed_dim=int(cfg["embed_dim"]), n_embed=int(cfg["n_embed"]),
        dropout=float(dd.get("dropout", 0.0)))


@dataclasses.dataclass(frozen=True)
class LoadedConfig:
    spec: CodecSpec
    strategy: Optional[TrainingStrategy]
    feat_cfg: FeatLossCfg
    img_cfg: ImgLossCfg
    tune_titok: bool = False
    raw: Optional[Dict] = None   # the whole YAML dict (data section, paths, ...)


def load_config(path) -> LoadedConfig:
    """Load a reference-layout YAML (config_test.yaml, the train configs),
    key for key as the JAX package's ``load_config``."""
    from .config_yaml import load_path
    from .train.steps import FeatLossCfg, ImgLossCfg
    from .train.strategy import TrainingStrategy
    raw = load_path(path)
    p = raw["model"]["params"]
    spec = CodecSpec(
        titok=_titok_from_yaml(p["config"]),
        vqgan=dataclasses.replace(_vqgan_from_yaml(p["vqganconfig"]),
                                  use_attn=not p.get("no_attn_vqgan", False)),
        feat_width=int(p.get("feat_dim", 768)),
        quant_dim=int(p.get("embed_dim", 64)),
        insert_pos_enc=tuple(p.get("in_pos_enc", (3, 7, 11, 15, 19))),
        insert_pos_dec=tuple(p.get("in_pos_dec", (3, 7, 11, 15, 19))),
        num_attns=int(p.get("n_attn", 2)),
        merge_inner_width=int(p.get("merge_inner_width", 1024)),
        remat=bool(p.get("save_mem", False)),
        force_zero_thres=float(p.get("force_zero_thres", 0.12)))

    strategy = None
    if "training_strategy" in p:
        strategy = TrainingStrategy.from_dict(p["training_strategy"])

    il = p.get("imglossconfig", {})
    img_cfg = ImgLossCfg(
        disc_start=int(il.get("disc_start", 0)),
        disc_weight=float(il.get("disc_weight", 0.75)),
        codebook_weight=float(il.get("codebook_weight", 1.0)),
        disc_num_layers=int(il.get("disc_num_layers", 3)),
        disc_ndf=int(il.get("disc_ndf", 64)),
        perceptual=str(il.get("perceptual", "lpips")))
    fl = p.get("featlossconfig", {})
    feat_cfg = FeatLossCfg(
        mse_weight=float(fl.get("mse_weight", 1.0)),
        ce_weight=float(fl.get("ce_weight", 0.25)),
        vq_weight=float(fl.get("vq_weight", 1.0)))
    return LoadedConfig(spec, strategy, feat_cfg, img_cfg,
                        tune_titok=bool(p.get("tune_titok", False)), raw=raw)
