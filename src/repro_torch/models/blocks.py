"""Per-layer transformer block with GQA or MLA attention and a dense MLP
or an MoE FFN, and gemma3's sandwich norms (port of
``repro/models/blocks.py``; Mamba2 and shared blocks come later)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, keep)


def init_transformer_block(gen: torch.Generator, cfg, *, device,
                           leaf=keep, use_moe: bool = False) -> dict:
    """``leaf(name, w)`` takes each f32 linear weight (and each slice of
    an expert stack) right after its draw. ``use_moe`` puts an MoE FFN
    (``moe``) where the dense MLP (``mlp``) would be. ``cfg.sandwich_norm``
    (gemma3) adds the norms applied to the attention's and the MLP's
    outputs before each residual add."""
    attn = (attn_mod.init_mla(gen, cfg, device=device, leaf=leaf)
            if cfg.mla is not None
            else attn_mod.init_attention(gen, cfg, device=device, leaf=leaf))
    p = dict(attn_norm=init_norm(cfg, device=device), attn=attn,
             mlp_norm=init_norm(cfg, device=device))
    if use_moe:
        p['moe'] = moe_mod.init_moe(gen, cfg, device=device, leaf=leaf)
    else:
        p['mlp'] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                            device=device, leaf=leaf)
    if cfg.sandwich_norm:
        p['post_attn_norm'] = init_norm(cfg, device=device)
        p['post_mlp_norm'] = init_norm(cfg, device=device)
    return p


def _mix_attn(p, x, cfg, yoco, *, window, theta, cache, decode_pos, rt,
              chunk_ctx):
    """Route the attention: chunked prefill, decode or prompt, MLA or GQA."""
    mla = cfg.mla is not None
    if chunk_ctx is not None:
        if mla:
            return attn_mod.mla_attention_chunk(
                p['attn'], x, cfg, yoco, cache=cache,
                offset=chunk_ctx['offset'], limit=chunk_ctx['limit'], rt=rt)
        return attn_mod.attention_chunk(
            p['attn'], x, cfg, yoco, cache=cache, offset=chunk_ctx['offset'],
            limit=chunk_ctx['limit'], window=window, theta=theta, rt=rt)
    if decode_pos is not None:
        if mla:
            return attn_mod.mla_attention_decode(
                p['attn'], x, cfg, yoco, cache=cache, pos=decode_pos, rt=rt)
        return attn_mod.attention_decode(p['attn'], x, cfg, yoco,
                                         cache=cache, pos=decode_pos,
                                         window=window, theta=theta, rt=rt)
    if mla:
        return attn_mod.mla_attention(p['attn'], x, cfg, yoco, cache=cache)
    return attn_mod.attention(p['attn'], x, cfg, yoco, window=window,
                              theta=theta, cache=cache)


def transformer_block(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                      window=None, theta=None, cache: Optional[dict] = None,
                      decode_pos=None, rt=None, chunk_ctx=None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm residual block. Returns (x, cache). ``chunk_ctx``
    (dict(offset=, limit=), both (B,) int32) routes the attention through
    the chunked-prefill path. An MoE block's router metrics are dropped
    here: serving reads none."""
    h = apply_norm(p['attn_norm'], x, cfg)
    a, cache = _mix_attn(p, h, cfg, yoco, window=window, theta=theta,
                         cache=cache, decode_pos=decode_pos, rt=rt,
                         chunk_ctx=chunk_ctx)
    if 'post_attn_norm' in p:
        a = apply_norm(p['post_attn_norm'], a, cfg)
    x = x + a
    h = apply_norm(p['mlp_norm'], x, cfg)
    if 'moe' in p:
        m, _ = moe_mod.moe_apply(p['moe'], h, cfg, yoco,
                                 with_metrics=False)
    else:
        m = apply_mlp(p['mlp'], h, cfg.mlp_type, yoco)
    if 'post_mlp_norm' in p:
        m = apply_norm(p['post_mlp_norm'], m, cfg)
    return x + m, cache
