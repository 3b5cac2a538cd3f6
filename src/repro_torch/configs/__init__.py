# Importing this package registers every ported architecture.
from repro_torch.configs import base  # noqa: F401
from repro_torch.configs import deepseek_v3_671b  # noqa: F401
from repro_torch.configs import stablelm_1p6b  # noqa: F401
from repro_torch.configs.base import ArchConfig, get, names  # noqa: F401
