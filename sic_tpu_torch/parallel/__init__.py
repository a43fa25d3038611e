"""Multi-process data, pipeline, tensor, spatial and FSDP parallelism.

Counterpart of the JAX package's ``parallel/`` (``multihost.py``,
``pipeline.py`` and ``mesh.py``) on ``torch.distributed``: processes take
the place of mesh devices.  ``data``: the ranks split each global batch
into contiguous equal blocks, and every batch mean and batch statistic is
reduced over them (:mod:`.multihost`); ``pipe``: the hybrid trunks' cells
run as GPipe stages, one process each (:mod:`.pipeline`); ``model``,
``tile`` and FSDP over ``data``: the JAX package's GSPMD shardings
(``--tp``, ``--tile``, ``--fsdp``, ``CodecRuntime(mesh=)``) as explicit
placements (:mod:`.mesh`) and collectives with autograd
(:mod:`.collectives`).
"""
from .collectives import (copy_to_model, no_tile, reduce_from_model,
                          run_gathered, tile_gather, tile_group, tile_halo,
                          tile_mean, tile_parallel, tile_roll, tile_scatter,
                          tile_sum)
from .mesh import (DEFAULT_TP_RULES, FSDP, Layout, Mesh, apply_tp, fsdp_plan,
                   make_mesh, shard_batch, shard_state, state_bytes, tp_plan)
from .multihost import (Group, all_mean, axis_groups, barrier, choose_backend,
                        env_world, gather_to_first, global_mean, global_rank,
                        grid_groups, rank_device, reduce_grads,
                        setup_distributed, shard_list, shutdown, take_rows)
from .pipeline import (bubble_fraction, codec_params_canonicalize,
                       codec_params_stack, pipeline_vit_trunk, spmd_pipeline,
                       stack_hybrid_cells, stack_trunk, unstack_hybrid_cells)

__all__ = ["DEFAULT_TP_RULES", "FSDP", "Group", "Layout", "Mesh", "all_mean",
           "apply_tp", "axis_groups", "barrier", "bubble_fraction",
           "choose_backend", "codec_params_canonicalize", "codec_params_stack",
           "copy_to_model", "env_world", "fsdp_plan", "gather_to_first",
           "global_mean", "global_rank", "grid_groups", "make_mesh", "no_tile",
           "pipeline_vit_trunk", "rank_device", "reduce_from_model",
           "reduce_grads", "run_gathered", "setup_distributed", "shard_batch",
           "shard_list", "shard_state", "shutdown", "spmd_pipeline",
           "stack_hybrid_cells", "stack_trunk", "state_bytes", "take_rows",
           "tile_gather", "tile_group", "tile_halo", "tile_mean",
           "tile_parallel", "tile_roll", "tile_scatter", "tile_sum", "tp_plan",
           "unstack_hybrid_cells"]
