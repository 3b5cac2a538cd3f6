"""gemma3-27b [dense] — 5:1 local:global attention, 128k context,
hf:google/gemma-3-27b-pt. 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name='gemma3-27b', family='dense',
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab_size=262144, head_dim=128,
    sliding_window=1024, local_global_every=6,   # 5 local : 1 global
    rope_theta=10000.0, global_rope_theta=1000000.0,
    qk_norm=True, sandwich_norm=True, mlp_type='geglu', norm_type='rmsnorm',
    max_seq_len=131072,
    source='hf:google/gemma-3-1b-pt scaled per card',
    notes='long_500k SKIPPED: global layers are full attention; 128k ctx limit',
)

SMOKE = ArchConfig(
    name='gemma3-27b', family='dense',
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    sliding_window=16, local_global_every=3,
    rope_theta=10000.0, global_rope_theta=1000000.0,
    qk_norm=True, sandwich_norm=True, mlp_type='geglu', norm_type='rmsnorm',
    max_seq_len=4096,
    source='smoke', notes='reduced gemma3 (2 local : 1 global)',
)

register(FULL, SMOKE)
