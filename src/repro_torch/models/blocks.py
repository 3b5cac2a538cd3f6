"""Per-layer blocks (port of ``repro/models/blocks.py``): the transformer
block with GQA or MLA attention and a dense MLP or an MoE FFN, and
gemma3's sandwich norms; the Mamba2 block; zamba2's shared attention+MLP
block, applied at several sites through a per-site input projection."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       init_mlp, init_norm, keep)


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
        return attn_mod.mla_attention(p['attn'], x, cfg, yoco, cache=cache,
                                      rt=rt)
    return attn_mod.attention(p['attn'], x, cfg, yoco, window=window,
                              theta=theta, cache=cache, rt=rt)


def transformer_block(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                      window=None, theta=None, cache: Optional[dict] = None,
                      decode_pos=None, rt=None, chunk_ctx=None,
                      aux: Optional[list] = None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm residual block. Returns (x, cache). ``chunk_ctx``
    (dict(offset=, limit=), both (B,) int32) routes the attention through
    the chunked-prefill path. An MoE block appends its router's
    load-balance loss to ``aux`` when one is given (the training forward,
    in the autograd graph); without it the router's metrics are skipped,
    as serving reads none."""
    h = apply_norm(p['attn_norm'], x, cfg)
    a, cache = _mix_attn(p, h, cfg, yoco, window=window, theta=theta,
                         cache=cache, decode_pos=decode_pos, rt=rt,
                         chunk_ctx=chunk_ctx)
    if 'post_attn_norm' in p:
        a = apply_norm(p['post_attn_norm'], a, cfg)
    x = x + a
    h = apply_norm(p['mlp_norm'], x, cfg)
    if 'moe' in p:
        m, metrics = moe_mod.moe_apply(
            p['moe'], h, cfg, yoco, None if rt is None else rt.moe_ctx,
            with_metrics=aux is not None, rt=rt)
        if aux is not None:
            aux.append(metrics['aux_loss'])
    else:
        m = apply_mlp(p['mlp'], h, cfg.mlp_type, yoco, rt=rt, cfg=cfg)
    if 'post_mlp_norm' in p:
        m = apply_norm(p['post_mlp_norm'], m, cfg)
    return x + m, cache


# ----------------------------------------------------------------------------
# mamba2 block
# ----------------------------------------------------------------------------
def init_mamba_block(gen: torch.Generator, cfg, *, device,
                     leaf=keep) -> dict:
    return dict(norm=init_norm(cfg, device=device),
                mixer=ssm_mod.init_mamba2(gen, cfg, device=device, leaf=leaf))


def mamba_block(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                state: Optional[dict] = None, decode: bool = False,
                last_pos=None, rt=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm residual Mamba2 block; ``state`` is updated in place. A
    rank holding its 1/T of the sequence (``rt.seq_sharded``) gathers the
    whole sequence over 'model' before the scan and keeps its rows of the
    mixer's output (each rank's cotangent is then its rows' part, and the
    gather reduce-scatters it)."""
    h = apply_norm(p['norm'], x, cfg)
    if decode:
        y, state = ssm_mod.mamba2_decode(p['mixer'], h, cfg, yoco,
                                         state=state)
    elif rt is not None and rt.seq_sharded:
        from repro_torch.distributed import collectives
        s = h.shape[1]
        whole = collectives.gather(h, 1, rt.model_group())
        y, state = ssm_mod.mamba2_forward(p['mixer'], whole, cfg, yoco,
                                          state=state, last_pos=last_pos)
        o = rt.seq_offset(s)
        y = y[:, o:o + s]
    else:
        y, state = ssm_mod.mamba2_forward(p['mixer'], h, cfg, yoco,
                                          state=state, last_pos=last_pos)
    return x + y, state


# ----------------------------------------------------------------------------
# zamba2 shared block (one attention+MLP block applied at several sites)
# ----------------------------------------------------------------------------
def init_shared_block(gen: torch.Generator, cfg, n_sites: int, *, device,
                      leaf=keep) -> dict:
    """The shared transformer block and per-site input projections (the
    Zamba2 pattern: the block's input is concat(hidden, embedding) -> d).
    ``in_proj`` (n_sites, 2d, d) is a float einsum weight, never passed to
    ``leaf``: it is no linear of ``yoco_linear`` (the reference quantizes
    it under --prequantize and then fails; the port refuses that mode)."""
    block = init_transformer_block(gen, cfg, device=device, leaf=leaf)
    in_proj = torch.stack([dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                      device=device)
                           for _ in range(n_sites)])
    return dict(block=block, in_proj=in_proj)


def shared_block(p: dict, x: torch.Tensor, x0: torch.Tensor, site: int,
                 cfg, yoco: YocoConfig, *, cache=None, decode_pos=None,
                 rt=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x0: the embedding stream (concat-conditioning). The residual adds
    the block's own delta, ``x + (y - h)``, in the block's dtype."""
    h = torch.cat([x, x0], dim=-1)
    h = torch.matmul(h, p['in_proj'][site].to(h.dtype))
    y, cache = transformer_block(p['block'], h, cfg, yoco, cache=cache,
                                 decode_pos=decode_pos, rt=rt)
    return x + (y - h), cache
