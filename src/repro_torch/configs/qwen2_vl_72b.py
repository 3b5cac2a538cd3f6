"""qwen2-vl-72b [vlm] — M-RoPE + dynamic resolution, arXiv:2409.12191.
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The vision frontend is a STUB per assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, seq, d_model)."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name='qwen2-vl-72b', family='vlm',
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064,
    rope_theta=1000000.0, mrope=True, attn_bias=True,
    mlp_type='swiglu', norm_type='rmsnorm',
    input_kind='embeddings', max_seq_len=32768,
    source='arXiv:2409.12191; hf',
    notes='backbone only; patch embeddings precomputed (frontend stub)',
)

SMOKE = ArchConfig(
    name='qwen2-vl-72b', family='vlm',
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab_size=256,
    rope_theta=1000000.0, mrope=True, attn_bias=True,
    mlp_type='swiglu', norm_type='rmsnorm',
    input_kind='embeddings', max_seq_len=4096,
    source='smoke', notes='reduced qwen2-vl backbone',
)

register(FULL, SMOKE)
