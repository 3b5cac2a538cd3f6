"""starcoder2-15b [dense] — GQA + RoPE, arXiv:2402.19173.
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name='starcoder2-15b', family='dense',
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152,
    rope_theta=100000.0, mlp_type='gelu', norm_type='layernorm',
    attn_bias=True, max_seq_len=16384,
    source='arXiv:2402.19173; hf',
    notes='non-gated GELU MLP, LayerNorm, biases',
)

SMOKE = ArchConfig(
    name='starcoder2-15b', family='dense',
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=256,
    vocab_size=256,
    rope_theta=100000.0, mlp_type='gelu', norm_type='layernorm',
    attn_bias=True, max_seq_len=4096,
    source='smoke', notes='reduced starcoder2',
)

register(FULL, SMOKE)
