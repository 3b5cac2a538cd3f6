"""Architecture configs: a copy of the reference's ``ArchConfig``, its
``MLAConfig`` and ``MoEConfig``, and its registry. Registered so far:
stablelm-1.6b and deepseek-v3-671b (whose MoE layers the port does not
serve yet: ``models.model`` refuses a config with ``moe`` set, so callers
serve its dense prefix, ``dataclasses.replace(cfg, n_layers=3, moe=None)``);
other architectures, and the reference's SSM and hybrid fields, join with
the families that serve them."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention (arXiv:2412.19437)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0           # per-expert hidden size
    n_shared: int = 0              # shared experts (deepseek/qwen style)
    d_ff_shared: int = 0           # total shared hidden size
    first_k_dense: int = 0         # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    impl: str = 'dense'            # dense | ep  (expert-parallel all_to_all)
    pad_experts_to: int = 0        # pad expert stacks for even EP sharding


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # stablelm: partial rotary (0.25)
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    attn_bias: bool = False
    mla: Optional[MLAConfig] = None
    mlp_type: str = 'swiglu'       # swiglu | gelu | geglu
    norm_type: str = 'rmsnorm'     # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    input_kind: str = 'tokens'
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    source: str = ''
    notes: str = ''

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0


_REGISTRY: Dict[str, ArchConfig] = {}
_SMOKE: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get(name: str, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers all archs)
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f'unknown arch {name!r}; have {sorted(table)}')
    return table[name]


def names() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
