"""Counterpart of ``parallel/``: the transformer's train step on one card
and over a ``(workers, model, seq)`` mesh of ranks
(``transformer_tp.py``), fully-sharded training over a ``workers`` axis
(``fsdp.py``), the pipeline's GPipe, 1F1B and interleaved schedules over
a ``(workers, stages)`` mesh (``pipeline.py``), the Switch-MoE layer and
its steps on one card and over ``experts`` ranks (``moe.py``), the
worker layout and the grids of rank axes (``mesh.py``) and the
collectives (``collectives.py``)."""

from dist_keras_tpu_torch.parallel.collectives import (
    tree_all_gather,
    tree_pmean,
    tree_ppermute,
    tree_psum,
)
from dist_keras_tpu_torch.parallel.fsdp import (
    fsdp_specs,
    make_fsdp_train_step,
    train_fsdp,
)
from dist_keras_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    WORKER_AXIS,
    grid_mesh,
    make_tp_mesh,
    worker_mesh,
)
from dist_keras_tpu_torch.parallel.moe import (
    init_moe_params,
    make_moe_ep_train_step,
    make_moe_train_step,
    moe_param_specs,
    moe_transformer_param_specs,
    switch_moe_dense,
    switch_moe_ep,
)
from dist_keras_tpu_torch.parallel.pipeline import (
    PIPE_AXIS,
    gpipe_apply,
    make_pp_mesh,
    make_pp_train_step,
    pipeline_1f1b,
    pp_transformer_1f1b_grads,
    pp_transformer_apply,
    stack_blocks,
    train_pp_transformer,
)
from dist_keras_tpu_torch.parallel.transformer_tp import (
    make_tp_train_step,
    tp_transformer_forward,
    train_tp_transformer,
)

__all__ = [
    "worker_mesh", "grid_mesh", "make_tp_mesh", "WORKER_AXIS", "MODEL_AXIS",
    "SEQ_AXIS", "tree_psum", "tree_pmean", "tree_all_gather",
    "tree_ppermute", "fsdp_specs", "make_fsdp_train_step", "train_fsdp",
    "EXPERT_AXIS", "init_moe_params", "moe_param_specs",
    "switch_moe_dense", "switch_moe_ep", "make_moe_train_step",
    "make_moe_ep_train_step", "moe_transformer_param_specs",
    "PIPE_AXIS", "gpipe_apply", "pp_transformer_apply", "stack_blocks",
    "pipeline_1f1b", "pp_transformer_1f1b_grads", "make_pp_mesh",
    "make_pp_train_step", "train_pp_transformer",
    "make_tp_train_step", "tp_transformer_forward", "train_tp_transformer",
]
