"""Training of the port: the three-stage schedule (``feat_wo_bpp`` ->
``feat`` -> ``pix``), its steps, state and loop."""
from .losses import (adaptive_d_weight, adopt_weight, cross_entropy,
                     feat_align_loss, hinge_d_loss, vanilla_d_loss)
from .state import (TrainState, is_frozen_path, make_optimizer,
                    named_codec_params, partition, stage_grad_mask)
from .steps import FeatLossCfg, ImgLossCfg, TrainSteps
from .strategy import STAGE_NAMES, StageSpec, TrainingStrategy
from .trainer import (Trainer, create_train_state, load_checkpoint,
                      save_checkpoint)

__all__ = ["adaptive_d_weight", "adopt_weight", "cross_entropy",
           "feat_align_loss", "hinge_d_loss", "vanilla_d_loss", "TrainState",
           "is_frozen_path", "make_optimizer", "named_codec_params",
           "partition", "stage_grad_mask", "FeatLossCfg", "ImgLossCfg",
           "TrainSteps", "STAGE_NAMES", "StageSpec", "TrainingStrategy",
           "Trainer", "create_train_state", "load_checkpoint",
           "save_checkpoint"]
