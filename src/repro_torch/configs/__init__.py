# One <arch>.py per architecture. Importing this package registers every
# config in repro_torch.configs.base.ARCHS (used by --arch lookups).
from . import (  # noqa: F401
    deepseek_v2_lite,
    granite_moe_1b,
    internlm2_20b,
    jamba_1_5_large,
    llava_next_34b,
    mamba2_370m,
    mistral_nemo_12b,
    nemotron_4_340b,
    olmo_1b,
    seamless_m4t_large,
)
from .base import ARCHS, SHAPES, ModelConfig, ShapeConfig, get_config  # noqa: F401
