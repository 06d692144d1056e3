"""Counterpart of ``parallel/``: the transformer's train step on one card
and over ``seq`` ranks (``transformer_tp.py``), the Switch-MoE layer and
its steps on one card and over ``experts`` ranks (``moe.py``), the
worker layout and the mesh axes over ranks (``mesh.py``) and the
collectives (``collectives.py``).  ``fsdp.py`` and ``pipeline.py`` wait
for ROADMAP queue 1, item 17."""

from dist_keras_tpu_torch.parallel.collectives import (
    tree_all_gather,
    tree_pmean,
    tree_ppermute,
    tree_psum,
)
from dist_keras_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    WORKER_AXIS,
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
from dist_keras_tpu_torch.parallel.transformer_tp import (
    make_tp_train_step,
    tp_transformer_forward,
    train_tp_transformer,
)

__all__ = [
    "worker_mesh", "make_tp_mesh", "WORKER_AXIS", "MODEL_AXIS", "SEQ_AXIS",
    "tree_psum", "tree_pmean", "tree_all_gather", "tree_ppermute",
    "EXPERT_AXIS", "init_moe_params", "moe_param_specs",
    "switch_moe_dense", "switch_moe_ep", "make_moe_train_step",
    "make_moe_ep_train_step", "moe_transformer_param_specs",
    "make_tp_train_step", "tp_transformer_forward", "train_tp_transformer",
]
