"""Architecture configs: a copy of the reference's ``ArchConfig``, its
``MLAConfig``, ``MoEConfig`` and ``SSMConfig``, its parameter count and
its registry. Registered so far: the dense GQA configs stablelm-1.6b,
stablelm-12b, starcoder2-15b and gemma3-27b (5 local sliding-window
layers to 1 global, sandwich norms), the Mixture-of-Experts configs
qwen2-moe-a2.7b (GQA with biases, every layer MoE, its 60 experts padded
to a stack of 64) and deepseek-v3-671b (MLA; 3 dense layers, then MoE
layers), which callers serve cut in depth, ``dataclasses.replace(cfg,
n_layers=5)`` (its 3 dense layers and 2 MoE layers) or ``replace(cfg,
n_layers=3, moe=None)`` (the dense prefix), and the recurrent configs
mamba2-780m (a pure SSM, 48 Mamba2 layers, tied embeddings) and
zamba2-1.2b (32 Mamba2 layers and 6 applications of one shared
attention+MLP block, ``hybrid_group`` 6), and the two configs whose input
is no token stream: qwen2-vl-72b (precomputed patch embeddings, M-RoPE,
q/k/v biases) and musicgen-large (4-codebook token grids, four summed
embedding tables, four heads): every config the reference registers."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


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
    # (zero dummy experts the router never addresses)

    @property
    def stack_size(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (arXiv:2405.21060)."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


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
    local_global_every: int = 0    # gemma3: 1 global per N+1 layers (N local)
    global_rope_theta: Optional[float] = None
    qk_norm: bool = False          # gemma3
    sandwich_norm: bool = False    # gemma3: post-attn/post-mlp norms
    attn_bias: bool = False        # qwen2-vl, starcoder2, qwen2-moe
    mrope: bool = False            # qwen2-vl multimodal rope (3 sections)
    mla: Optional[MLAConfig] = None
    mlp_type: str = 'swiglu'       # swiglu | gelu | geglu
    norm_type: str = 'rmsnorm'     # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_group: int = 0          # zamba2: layers per shared-attn group
    input_kind: str = 'tokens'     # tokens | embeddings | codebooks
    n_codebooks: int = 1           # musicgen: 4
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    source: str = ''
    notes: str = ''

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == 'ssm'

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: needs sub-quadratic sequence mixing."""
        return self.family in ('ssm', 'hybrid')

    def per_token_matmuls(self) -> List[Tuple[str, int, int, float]]:
        """[(name, K, N, count_per_token)] for every linear a decode token
        runs (the reference's accounting, for the families the port
        serves); MoE counts only the activated experts. Mamba2 layers are
        counted over all ``n_layers`` and a hybrid's attention and MLP over
        ``n_layers / hybrid_group`` applications, as the reference counts
        them."""
        d, dh = self.d_model, self.resolved_head_dim
        n = float(self.n_layers)
        mm: List[Tuple[str, int, int, float]] = []
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            mm += [('ssm_in', d, 2 * d_in + 2 * s.n_groups * s.d_state
                    + d_in // s.head_dim, n),
                   ('ssm_out', d_in, d, n)]
        head = ('lm_head', d, self.vocab_size * self.n_codebooks, 1.0)
        if self.family == 'ssm':
            return mm + [head]
        if self.hybrid_group:
            n = n / self.hybrid_group
        if self.mla is not None:
            m, h = self.mla, self.n_heads
            mm += [('q_down', d, m.q_lora_rank, n),
                  ('q_up', m.q_lora_rank,
                   h * (m.nope_head_dim + m.rope_head_dim), n),
                  ('kv_down', d, m.kv_lora_rank + m.rope_head_dim, n),
                  ('kv_up', m.kv_lora_rank,
                   h * (m.nope_head_dim + m.v_head_dim), n),
                  ('o', h * m.v_head_dim, d, n)]
        else:
            mm += [('q', d, self.n_heads * dh, n),
                  ('kv', d, 2 * self.n_kv_heads * dh, n),
                  ('o', self.n_heads * dh, d, n)]
        wide = 2 if self.mlp_type in ('swiglu', 'geglu') else 1
        if self.moe is None:
            mm += [('mlp_in', d, wide * self.d_ff, n),
                   ('mlp_out', self.d_ff, d, n)]
        else:
            mo = self.moe
            n_moe = n - mo.first_k_dense
            if mo.first_k_dense:
                mm += [('dense_mlp_in', d, wide * self.d_ff,
                        mo.first_k_dense),
                       ('dense_mlp_out', self.d_ff, d, mo.first_k_dense)]
            mm += [('router', d, mo.n_experts, n_moe),
                   ('expert_in', d, wide * mo.d_ff_expert, n_moe * mo.top_k),
                   ('expert_out', mo.d_ff_expert, d, n_moe * mo.top_k)]
            if mo.d_ff_shared:
                mm += [('shared_in', d, wide * mo.d_ff_shared, n_moe),
                       ('shared_out', mo.d_ff_shared, d, n_moe)]
        return mm + [head]

    def param_count(self) -> int:
        """Total parameters, embeddings included (the reference's count:
        an embedding table a codebook for every input kind, although
        ``embeddings`` input draws none)."""
        total = self.vocab_size * self.d_model * self.n_codebooks
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model * self.n_codebooks
        for name, kk, nn, cnt in self.per_token_matmuls():
            if name == 'lm_head':
                continue
            if name.startswith('expert_'):
                # all experts exist even though top_k are active
                cnt = cnt / self.moe.top_k * self.moe.n_experts
            total += int(kk * nn * cnt)
        return total + int(2 * self.d_model * self.n_layers)   # norms

    def active_param_count(self) -> int:
        """Parameters one token passes through (the reference's count):
        one embedding table a codebook and the linears of
        :meth:`per_token_matmuls` but the lm_head, MoE experts counted
        at ``top_k``."""
        total = self.vocab_size * self.d_model * self.n_codebooks
        for name, kk, nn, cnt in self.per_token_matmuls():
            if name == 'lm_head':
                continue
            total += int(kk * nn * cnt)
        return total


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


# ----------------------------------------------------------------------------
# the reference's input shapes (seq_len, global_batch) per cell kind
# ----------------------------------------------------------------------------
SHAPES: Dict[str, Dict] = {
    'train_4k': dict(seq_len=4096, global_batch=256, kind='train'),
    'prefill_32k': dict(seq_len=32768, global_batch=32, kind='prefill'),
    'decode_32k': dict(seq_len=32768, global_batch=128, kind='decode'),
    'long_500k': dict(seq_len=524288, global_batch=1, kind='decode'),
}


def cell_is_live(cfg: ArchConfig, shape_name: str) -> bool:
    """The reference's rule: long_500k only for sub-quadratic archs."""
    if shape_name == 'long_500k':
        return cfg.supports_long_context
    return True
