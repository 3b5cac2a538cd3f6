"""mamba2-780m [ssm] — SSD (state-space duality), arXiv:2405.21060.
48L d_model=1536, attention-free, vocab=50280, ssm_state=128."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name='mamba2-780m', family='ssm',
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                  conv_width=4, chunk_size=256),
    norm_type='rmsnorm', tie_embeddings=True, max_seq_len=1048576,
    source='arXiv:2405.21060',
    notes='pure SSM; long_500k eligible (O(1) state decode)',
)

SMOKE = ArchConfig(
    name='mamba2-780m', family='ssm',
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=128,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                  conv_width=4, chunk_size=32),
    norm_type='rmsnorm', tie_embeddings=True, max_seq_len=4096,
    source='smoke', notes='reduced mamba2',
)

register(FULL, SMOKE)
