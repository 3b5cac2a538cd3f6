"""Per-layer transformer block on the dense path (port of
``repro/models/blocks.py``; MoE, Mamba2 and shared blocks come later)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def init_transformer_block(gen: torch.Generator, cfg, *, device) -> dict:
    return dict(attn_norm=init_norm(cfg, device=device),
                attn=attn_mod.init_attention(gen, cfg, device=device),
                mlp_norm=init_norm(cfg, device=device),
                mlp=init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                             device=device))


def transformer_block(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                      window=None, theta=None, cache: Optional[dict] = None,
                      decode_pos=None, rt=None, chunk_ctx=None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm residual block. Returns (x, cache). ``chunk_ctx``
    (dict(offset=, limit=), both (B,) int32) routes the attention through
    the chunked-prefill path."""
    h = apply_norm(p['attn_norm'], x, cfg)
    if chunk_ctx is not None:
        a, cache = attn_mod.attention_chunk(
            p['attn'], h, cfg, yoco, cache=cache, offset=chunk_ctx['offset'],
            limit=chunk_ctx['limit'], window=window, theta=theta, rt=rt)
    elif decode_pos is not None:
        a, cache = attn_mod.attention_decode(p['attn'], h, cfg, yoco,
                                             cache=cache, pos=decode_pos,
                                             window=window, theta=theta,
                                             rt=rt)
    else:
        a, cache = attn_mod.attention(p['attn'], h, cfg, yoco, window=window,
                                      theta=theta, cache=cache)
    x = x + a
    h = apply_norm(p['mlp_norm'], x, cfg)
    return x + apply_mlp(p['mlp'], h, cfg.mlp_type, yoco), cache
