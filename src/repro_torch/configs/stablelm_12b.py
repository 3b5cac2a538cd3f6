"""stablelm-12b [dense] — hf:stabilityai/stablelm-2-12b.
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name='stablelm-12b', family='dense',
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab_size=100352,
    rope_theta=10000.0, rope_fraction=0.25,
    mlp_type='swiglu', norm_type='layernorm', max_seq_len=4096,
    source='hf:stabilityai/stablelm-2-12b',
    notes='partial rotary (25%)',
)

SMOKE = ArchConfig(
    name='stablelm-12b', family='dense',
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=256,
    rope_theta=10000.0, rope_fraction=0.25,
    mlp_type='swiglu', norm_type='layernorm', max_seq_len=4096,
    source='smoke', notes='reduced stablelm-12b',
)

register(FULL, SMOKE)
