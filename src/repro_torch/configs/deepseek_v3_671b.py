"""deepseek-v3-671b [moe] — MLA + 1 shared/256 routed top-8 MoE (+MTP),
arXiv:2412.19437. 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.

The first ``first_k_dense = 3`` layers are MLA blocks with a SwiGLU MLP of
``d_ff = 18432`` (the ``dense_prefix`` stack); the other 58 are MLA blocks
with an MoE FFN (256 routed experts top-8 and one shared expert, each 2048
wide). One card holds it cut in depth: callers register
``dataclasses.replace(FULL, name=..., n_layers=5)`` (3 dense layers and 2
MoE layers) or the dense prefix alone, ``replace(FULL, n_layers=3,
moe=None)``, at run time."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

FULL = ArchConfig(
    name='deepseek-v3-671b', family='moe',
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                       # dense layers (first 3)
    vocab_size=129280, head_dim=128,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared=1, d_ff_shared=2048, first_k_dense=3,
                  capacity_factor=1.25, impl='ep'),
    mlp_type='swiglu', norm_type='rmsnorm', max_seq_len=131072,
    source='arXiv:2412.19437; hf',
    notes='MLA latent KV cache; MTP head available via train flag',
)

SMOKE = ArchConfig(
    name='deepseek-v3-671b', family='moe',
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                  d_ff_shared=32, first_k_dense=1, impl='dense'),
    mlp_type='swiglu', norm_type='rmsnorm', max_seq_len=4096,
    source='smoke', notes='reduced deepseek-v3 (MLA+MoE)',
)

register(FULL, SMOKE)
