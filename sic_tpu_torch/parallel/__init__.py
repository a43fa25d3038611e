"""Multi-process data parallelism and GPipe pipeline parallelism.

Counterpart of the JAX package's ``parallel/`` (``multihost.py`` and
``pipeline.py``) on ``torch.distributed``: processes take the place of
mesh devices.  ``data``: the ranks split each global batch into contiguous
equal blocks, and every batch mean and batch statistic is reduced over
them (:mod:`.multihost`); ``pipe``: the hybrid trunks' cells run as GPipe
stages, one process each (:mod:`.pipeline`).  The JAX package's GSPMD
shardings (``mesh.py``: ``--tp``, ``--tile``, ``--fsdp``,
``CodecRuntime(mesh=)``) have no counterpart yet.
"""
from .multihost import (Group, all_mean, barrier, choose_backend, env_world,
                        gather_to_first, global_mean, global_rank, grid_groups,
                        rank_device, reduce_grads, setup_distributed, shard_list,
                        shutdown, take_rows)
from .pipeline import (bubble_fraction, codec_params_canonicalize,
                       codec_params_stack, pipeline_vit_trunk, spmd_pipeline,
                       stack_hybrid_cells, stack_trunk, unstack_hybrid_cells)

__all__ = ["Group", "all_mean", "barrier", "bubble_fraction", "choose_backend",
           "codec_params_canonicalize", "codec_params_stack", "env_world",
           "gather_to_first", "global_mean", "global_rank", "grid_groups",
           "pipeline_vit_trunk", "rank_device", "reduce_grads",
           "setup_distributed", "shard_list", "shutdown", "spmd_pipeline",
           "stack_hybrid_cells", "stack_trunk", "take_rows",
           "unstack_hybrid_cells"]
