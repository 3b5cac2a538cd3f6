"""musicgen-large [audio] — decoder-only over EnCodec tokens, arXiv:2306.05284.
48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048 (per codebook).
The EnCodec frontend is a STUB per assignment: inputs are 4-codebook token
grids (batch, seq, 4); embeddings of the 4 codebooks are summed, and 4
parallel LM heads predict the next frame (delay pattern handled by the data
pipeline)."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name='musicgen-large', family='audio',
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0, mlp_type='gelu', norm_type='layernorm',
    input_kind='codebooks', n_codebooks=4, max_seq_len=32768,
    source='arXiv:2306.05284; hf',
    notes='backbone only; text conditioning omitted (decoder-only assignment)',
)

SMOKE = ArchConfig(
    name='musicgen-large', family='audio',
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=64,
    rope_theta=10000.0, mlp_type='gelu', norm_type='layernorm',
    input_kind='codebooks', n_codebooks=4, max_seq_len=4096,
    source='smoke', notes='reduced musicgen',
)

register(FULL, SMOKE)
