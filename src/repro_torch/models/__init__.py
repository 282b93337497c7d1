# Model zoo: the parameter system and the layer families (GQA/MLA
# attention, MoE, Mamba-2 SSD, hybrid stacks, enc-dec) on PyTorch tensors.
from .model import Model, build_model
from .params import (
    ParamDef,
    constrain_defs,
    init_params,
    params_from_arrays,
    shard,
    stack_defs,
    tree_map,
)

__all__ = [
    "Model",
    "build_model",
    "ParamDef",
    "constrain_defs",
    "init_params",
    "params_from_arrays",
    "shard",
    "stack_defs",
    "tree_map",
]
