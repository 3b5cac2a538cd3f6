"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks,
arXiv:2411.15242. 38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.

Structure: 6 groups x (5 Mamba2 layers + 1 shared transformer block) +
2 trailing Mamba2 layers = 38 sequence-mixing layers with 6 applications of
ONE shared attention+MLP block (parameters shared across applications), the
Zamba2 pattern. KV caches are per application site."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name='zamba2-1.2b', family='hybrid',
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  conv_width=4, chunk_size=256),
    hybrid_group=6,
    rope_theta=10000.0, mlp_type='gelu', norm_type='rmsnorm',
    max_seq_len=1048576,
    source='arXiv:2411.15242; hf',
    notes='long_500k eligible; shared-attn KV cache seq-sharded at 512k',
)

SMOKE = ArchConfig(
    name='zamba2-1.2b', family='hybrid',
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                  conv_width=4, chunk_size=32),
    hybrid_group=3,
    rope_theta=10000.0, mlp_type='gelu', norm_type='rmsnorm',
    max_seq_len=4096,
    source='smoke', notes='reduced zamba2 (2 groups of 3 + 2 tail)',
)

register(FULL, SMOKE)
