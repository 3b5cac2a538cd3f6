"""Common layers: norms, MLPs, embeddings (port of ``repro/models/
layers.py``). All matmuls route through ``core.yoco_linear``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import yoco_linear
from repro_torch.core.yoco_linear import YocoConfig


# ----------------------------------------------------------------------------
# init helpers (same distributions as the reference; torch.Generator draws)
# ----------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    # scaled in place: one f32 weight alive, not two
    return torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                       device=device).mul_(scale)


def keep(name: str, w: torch.Tensor) -> torch.Tensor:
    """The identity ``leaf`` of the init functions: a linear weight stays
    the f32 draw."""
    return w


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               device) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                       device=device) * 0.02


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def init_norm(cfg, *, device, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_type == 'rmsnorm':
        return dict(scale=torch.zeros((d,), dtype=torch.float32,
                                      device=device))
    return dict(scale=torch.ones((d,), dtype=torch.float32, device=device),
                bias=torch.zeros((d,), dtype=torch.float32, device=device))


def apply_norm(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm_type == 'rmsnorm':
        return rmsnorm(x, params['scale'])
    return layernorm(x, params['scale'], params['bias'])


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, d_ff: int, mlp_type: str, *,
             device, leaf=keep) -> dict:
    """``leaf(name, w)`` takes each f32 weight right after its draw, before
    the next draw (``models.model.init_params``' serving form)."""
    if mlp_type in ('swiglu', 'geglu'):
        return dict(w_gate=leaf('w_gate', dense_init(gen, d, d_ff,
                                                     device=device)),
                    w_up=leaf('w_up', dense_init(gen, d, d_ff,
                                                 device=device)),
                    w_down=leaf('w_down', dense_init(gen, d_ff, d,
                                                     device=device)))
    return dict(w_in=leaf('w_in', dense_init(gen, d, d_ff, device=device)),
                w_out=leaf('w_out', dense_init(gen, d_ff, d, device=device)))


def _gelu_tanh(t: torch.Tensor) -> torch.Tensor:
    return F.gelu(t, approximate='tanh')


def apply_mlp(params: dict, x: torch.Tensor, mlp_type: str,
              yoco: YocoConfig, rt=None, cfg=None) -> torch.Tensor:
    """The MLP. A rank's block of its hidden units (the 'tp' layout: the
    up weights' columns, the down weight's rows, fewer than ``cfg.d_ff``)
    runs Megatron's pair: x enters through ``collectives.copy_in`` (its
    cotangent summed over 'model'), and the down product is a row-parallel
    linear summed over 'model' (``yoco_linear.row_linear``)."""
    wide = mlp_type in ('swiglu', 'geglu')
    ups = [params['w_gate'], params['w_up']] if wide else [params['w_in']]
    down = params['w_down'] if wide else params['w_out']
    group, rank, ways = None, 0, 1
    if (cfg is not None and rt is not None
            and yoco_linear.weight_shape(down)[0] < cfg.d_ff):
        from repro_torch.distributed import collectives
        group = rt.model_group()
        rank, ways = rt.columns()
        x = collectives.copy_in(x, group)
    # one quantization of x for gate and up (w8a8)
    hs = yoco_linear.column_linears(x, ups, cfg=yoco, rank=rank, ways=ways)
    if wide:
        act = F.silu if mlp_type == 'swiglu' else _gelu_tanh
        h = act(hs[0]) * hs[1]
    else:
        h = _gelu_tanh(hs[0])
    return yoco_linear.row_linear(h, down, yoco, group=group)


# ----------------------------------------------------------------------------
# embeddings / heads
# ----------------------------------------------------------------------------
def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """tokens: (...,) int -> (..., d) in ``dtype``; with a codebook table
    ``emb`` (CB, V, d) (musicgen), tokens (..., CB): each codebook's rows
    gathered and summed in the table's dtype, codebook 0 first, as the
    reference's ``sum(parts)``, and only the sum cast."""
    tokens = tokens.to(torch.int64)
    if emb.ndim == 3:
        total = 0
        for c in range(emb.shape[0]):
            total = total + emb[c][tokens[..., c]]
        return total.to(dtype)
    return emb[tokens].to(dtype)


def is_codebook_head(name: str, w) -> bool:
    """A codebook model's (CB, d, V) ``lm_head``."""
    return (name == 'lm_head' and isinstance(w, torch.Tensor)
            and w.ndim == 3)


def lm_head(w, x: torch.Tensor, yoco: YocoConfig) -> torch.Tensor:
    """x: (..., d) -> logits (..., V), or (..., CB, V) with a codebook head
    ``w`` (CB, d, V). The codebook head is the reference model's float
    einsum with the head cast to x's dtype, in every mode: no kernel and no
    int8 (its ``quantize_tree`` skips a 3-D ``lm_head``)."""
    if is_codebook_head('lm_head', w):
        return torch.einsum('...d,cdv->...cv', x, w.to(x.dtype))
    return yoco_linear.yoco_matmul(x, w, yoco)
