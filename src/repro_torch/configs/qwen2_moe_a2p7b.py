"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4,
hf:Qwen/Qwen1.5-MoE-A2.7B. 24L d_model=2048 16H d_ff(expert)=1408 vocab=151936.

Every layer is an MoE layer: GQA attention with biases, a router over the
60 experts, and the 4 shared experts fused into one 5632-wide SwiGLU FFN.
The expert stacks are padded to 64 (``pad_experts_to``): the 4 dummy
experts are zero and never routed."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name='qwen2-moe-a2.7b', family='moe',
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5632,
    vocab_size=151936,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared=4, d_ff_shared=5632, first_k_dense=0,
                  capacity_factor=1.25, impl='ep', pad_experts_to=64),
    mlp_type='swiglu', norm_type='rmsnorm', attn_bias=True,
    max_seq_len=32768,
    source='hf:Qwen/Qwen1.5-MoE-A2.7B',
    notes='shared experts fused into one 5632-wide FFN (=4x1408)',
)

SMOKE = ArchConfig(
    name='qwen2-moe-a2.7b', family='moe',
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                  d_ff_shared=96, impl='dense'),
    mlp_type='swiglu', norm_type='rmsnorm', attn_bias=True, max_seq_len=4096,
    source='smoke', notes='reduced qwen2-moe',
)

register(FULL, SMOKE)
