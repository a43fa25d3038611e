"""Three-stage training strategy + validation-bpp rate controller.

The port's own copy of the JAX package's ``train/strategy.py`` (pure
Python; reference: src/models/codec_sq_fixbpp.py:523-647).  Stages:

0. ``feat_wo_bpp`` - align the fused latent with the frozen VQGAN teacher,
   bpp band effectively open;
1. ``feat``        - same objective, band tightens, lambda adapts;
2. ``pix``         - full pixel decode with LPIPS+GAN, VQGAN decoder unfrozen.

After each validation epoch the lambda *index* steps +-1 when the mean
validation bpp leaves the stage's ``[bpp_lower, bpp_upper]`` band
(reference: codec_sq_fixbpp.py:626-637).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

STAGE_NAMES = ("feat_wo_bpp", "feat", "pix")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    epoch_num: int
    init_lmbda_idx: int
    lmbda_list: Tuple[float, ...]
    bpp_upper: float
    bpp_lower: float


@dataclasses.dataclass(frozen=True)
class TrainingStrategy:
    learning_rate: float = 5e-5
    start_epoch: int = 0
    stages: Tuple[StageSpec, StageSpec, StageSpec] = (
        StageSpec(1, 0, (1.0, 7.2, 7.37), 2.0, 0.001),
        StageSpec(4, 0, (1.0, 7.2, 7.37), 0.012, 0.007),
        StageSpec(90, 0, (1.0, 7.2, 7.37), 0.015, 0.010),
    )

    @classmethod
    def from_dict(cls, d: Dict) -> "TrainingStrategy":
        """Parse the reference YAML layout
        (reference: src/config/config_test.yaml:80-107)."""
        stages = tuple(
            StageSpec(
                epoch_num=int(d[f"stage{i}"]["epoch_num"]),
                init_lmbda_idx=int(d[f"stage{i}"]["init_lmbda_idx"]),
                lmbda_list=tuple(float(x) for x in d[f"stage{i}"]["lmbda_list"]),
                bpp_upper=float(d[f"stage{i}"]["bpp_upper"]),
                bpp_lower=float(d[f"stage{i}"]["bpp_lower"]),
            ) for i in range(3))
        return cls(learning_rate=float(d.get("learning_rate", 5e-5)),
                   start_epoch=int(d.get("start_epoch", 0)), stages=stages)

    @property
    def total_epochs(self) -> int:
        return sum(s.epoch_num for s in self.stages)

    def stage_at(self, epoch: int) -> Tuple[str, StageSpec]:
        """Stage name + spec for an absolute epoch index (clamped to last)."""
        e = epoch
        for name, spec in zip(STAGE_NAMES, self.stages):
            if e < spec.epoch_num:
                return name, spec
            e -= spec.epoch_num
        return STAGE_NAMES[-1], self.stages[-1]

    def adjust_lmbda_idx(self, epoch: int, lmbda_idx: int,
                         val_bpp: float) -> int:
        """The +-1 bpp-band controller (reference: codec_sq_fixbpp.py:626-637)."""
        _, spec = self.stage_at(epoch)
        hi = len(spec.lmbda_list) - 1
        if val_bpp > spec.bpp_upper:
            return min(lmbda_idx + 1, hi)
        if val_bpp < spec.bpp_lower:
            return max(lmbda_idx - 1, 0)
        return lmbda_idx
