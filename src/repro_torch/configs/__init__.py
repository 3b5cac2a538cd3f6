# Importing this package registers every ported architecture.
from repro_torch.configs import base  # noqa: F401
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b, gemma3_27b, mamba2_780m, musicgen_large,
    qwen2_moe_a2p7b, qwen2_vl_72b, stablelm_12b, stablelm_1p6b,
    starcoder2_15b, zamba2_1p2b,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, cell_is_live, get, names)
