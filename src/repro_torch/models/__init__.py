# Model zoo: the parameter system and the layer families (GQA/MLA
# attention, MoE, Mamba-2 SSD, hybrid stacks, enc-dec) on PyTorch tensors.
from .model import Model, build_model, input_specs
from .params import (
    DECODE_RULES,
    TRAIN_RULES,
    TRAIN_RULES_SP,
    AbstractMesh,
    ParamDef,
    Rules,
    abstract_params,
    constrain_defs,
    init_params,
    param_specs,
    params_from_arrays,
    shard,
    sharding_ctx,
    stack_defs,
    tree_map,
)

__all__ = [
    "Model",
    "build_model",
    "input_specs",
    "ParamDef",
    "Rules",
    "TRAIN_RULES",
    "TRAIN_RULES_SP",
    "DECODE_RULES",
    "AbstractMesh",
    "abstract_params",
    "constrain_defs",
    "init_params",
    "param_specs",
    "params_from_arrays",
    "shard",
    "sharding_ctx",
    "stack_defs",
    "tree_map",
]
