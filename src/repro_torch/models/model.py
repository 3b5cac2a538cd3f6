"""Model assembly on the dense path (port of ``repro/models/model.py``).

  init_params(gen, cfg, device)                  -> param tree
  init_cache_tree(cfg, batch, max_seq, ...)      -> contiguous cache tree
  init_paged_cache_tree(cfg, batch, ...)         -> paged cache tree
  prefill(params, batch, cache, cfg, ...)        -> (last_logits, cache)
  prefill_chunk(params, batch, offset, limit, cache, ...)
                                                 -> (logits, cache)
  decode_step(params, token, pos, cache, ...)    -> (logits, cache)

Parameters are a plain dict with the reference's names; ``layers`` is a
list of per-layer dicts (a Python loop replaces ``lax.scan``). Caches keep
the reference's layer-stacked schema, ``dict(layers=dict(k=(L, P, ps, Hkv,
dh), v=..., bt=(L, B, W)))`` (MLA configs: one latent pool ``cl`` (L, P,
ps, r + d_rope)), or contiguous ``dict(layers=dict(k=(L, B, S_max, Hkv,
dh), v=...))`` (MLA: ``ckv``/``krope`` (L, B, S_max, ·)); each layer works
on views of the stacked tensors and writes them IN PLACE. Served: token
models with dense MLPs and GQA or MLA attention (:func:`_check_dense`
refuses the rest by feature).

``params_from_numpy`` / ``cache_from_numpy`` / ``cache_to_numpy`` carry the
reference's trees (as numpy arrays) across, so the two packages can be run
on the same weights and compared pool for pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import yoco_linear
from repro_torch.core.yoco_linear import DEFAULT_YOCO, QuantizedWeight, YocoConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.layers import apply_norm, dense_init, embed_init, init_norm


@dataclasses.dataclass(frozen=True)
class ModelRuntime:
    attn_impl: str = 'einsum'      # einsum (oracle) | flash (the kernels)
    compute_dtype: Any = torch.bfloat16


DEFAULT_RT = ModelRuntime()


def _check_dense(cfg) -> None:
    """Refuse, by feature, what the port does not serve yet. A family name
    says too little: deepseek-v3's dense prefix keeps ``family='moe'``
    with ``moe=None``, as in the reference."""
    later = [(cfg.moe is not None, 'MoE layers (ROADMAP Queue 1 item 11)'),
             (cfg.input_kind != 'tokens',
              f'{cfg.input_kind!r} input (Queue 1 item 11)')]
    for refused, what in later:
        if refused:
            raise NotImplementedError(
                f'{cfg.name}: {what} belong to a later slice of the port; '
                f'it serves token models with dense MLPs and GQA or MLA '
                f'attention')


# ----------------------------------------------------------------------------
# init and interchange
# ----------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg, *, device=None) -> dict:
    """Random weights with the reference's distributions (embeddings
    N(0, 0.02^2), linears N(0, 1/d_in), norms at identity), drawn from
    ``gen`` directly on ``device`` (default: the card; with no card it
    raises unless the caller passes ``device='cpu'``). The draws differ
    from JAX's PRNG; to compare with the reference use
    :func:`params_from_numpy`."""
    _check_dense(cfg)
    device = device_mod.resolve(device)
    p = dict(embed=embed_init(gen, cfg.vocab_size, cfg.d_model,
                              device=device))
    p['layers'] = [blk.init_transformer_block(gen, cfg, device=device)
                   for _ in range(cfg.n_layers)]
    p['final_norm'] = init_norm(cfg, device=device)
    if not cfg.tie_embeddings:
        p['lm_head'] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  device=device)
    return p


def _is_quantized_leaf(x) -> bool:
    return getattr(x, '_fields', None) == ('wq', 'scale')


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The reference's param tree, as numpy arrays (stacked ``(L, ...)``
    layer leaves, ``QuantizedWeight(wq, scale)`` leaves allowed), to the
    port's: tensors on ``device`` with the layer stack split into a list,
    int8 weights stored K-major as kernel K2 reads them."""
    _check_dense(cfg)

    def conv(node, layer=None):
        if _is_quantized_leaf(node):
            wq, scale = node
            if layer is not None:
                wq, scale = wq[layer], scale[layer]
            return QuantizedWeight(yoco_linear.k_major(conv(wq)),
                                   conv(scale))
        if isinstance(node, dict):
            return {k: conv(v, layer) for k, v in node.items()}
        arr = np.asarray(node)
        if layer is not None:
            arr = arr[layer]
        return torch.from_numpy(np.array(arr)).to(device)

    out = {k: conv(v) for k, v in tree.items() if k != 'layers'}
    out['layers'] = [conv(tree['layers'], l) for l in range(cfg.n_layers)]
    return out


# Kept f32 by cast_linear_weights: MLA decode absorbs W_uk into the query
# and applies W_uv to the latent output in f32 on the f32 weights, as the
# reference does (its params are f32 masters); its prefill linear casts
# w_ukv to the compute dtype per call, as every reference linear does.
_F32_WEIGHTS = ('w_ukv',)


def cast_linear_weights(params: dict, dtype: torch.dtype) -> dict:
    """Store every float linear weight once in ``dtype`` (the bf16 mode's
    compute dtype), which the reference casts to on every call instead;
    the weights in ``_F32_WEIGHTS`` stay f32."""
    def walk(node, name=''):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if (isinstance(node, torch.Tensor) and node.is_floating_point()
                and node.ndim == 2 and name in yoco_linear._WEIGHT_NAMES
                and name not in _F32_WEIGHTS):
            return node.to(dtype)
        return node
    return walk(params)


def k_major_linear_weights(params: dict) -> dict:
    """Store every float linear weight K-major once, at load: the same
    (K, N) values as a view of an (N, K)-contiguous tensor
    (``yoco_linear.k_major``), f32 as the reference keeps them. Dynamic
    w8a8 serves these: kernel K3 reads ``w.T`` in place and kernel K4 takes
    its codes as the K-major operand, so no call copies a weight. One
    weight is copied at a time; one already K-major is not copied."""
    def walk(node, name=''):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if (isinstance(node, torch.Tensor) and node.is_floating_point()
                and node.ndim == 2 and name in yoco_linear._WEIGHT_NAMES):
            return yoco_linear.k_major(node)
        return node
    return walk(params)


def cache_from_numpy(tree, device):
    """A reference cache tree (numpy leaves) to tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: cache_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def cache_to_numpy(tree):
    """A port cache tree to numpy leaves (bf16 pools come back as f32)."""
    if isinstance(tree, dict):
        return {k: cache_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.contiguous().numpy()


# ----------------------------------------------------------------------------
# embedding / head / stack
# ----------------------------------------------------------------------------
def _embed(params: dict, tokens: torch.Tensor, rt: ModelRuntime) -> torch.Tensor:
    return params['embed'][tokens.to(torch.int64)].to(rt.compute_dtype)


def _head(params: dict, x: torch.Tensor, cfg, yoco: YocoConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return yoco_linear.yoco_matmul(x, params['embed'].t().to(x.dtype),
                                       yoco)
    return yoco_linear.yoco_matmul(x, params['lm_head'], yoco)


def _transformer_stack(layers: list, x: torch.Tensor, cfg, yoco, rt, *,
                       cache: Optional[dict], decode_pos, chunk_ctx=None):
    """Run the layers in order; ``cache`` is the stacked (L, ...) dict or
    None, and each layer gets views of its own slice."""
    for l, lp in enumerate(layers):
        lc = ({key: leaf[l] for key, leaf in cache.items()}
              if cache is not None else None)
        x, _ = blk.transformer_block(lp, x, cfg, yoco,
                                     window=cfg.sliding_window, cache=lc,
                                     decode_pos=decode_pos, rt=rt,
                                     chunk_ctx=chunk_ctx)
    return x, cache


def _backbone(params: dict, x: torch.Tensor, cfg, yoco, rt, *,
              cache: Optional[dict], decode_pos, chunk_ctx=None):
    lc = cache['layers'] if cache is not None else None
    x, lc = _transformer_stack(params['layers'], x, cfg, yoco, rt,
                               cache=lc, decode_pos=decode_pos,
                               chunk_ctx=chunk_ctx)
    return x, (dict(cache, layers=lc) if cache is not None else None)


# ----------------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------------
def init_cache_tree(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                    device=None) -> dict:
    """One contiguous cache per layer, stacked over L (the static
    ``serve()`` path's): ``k``/``v`` (L, B, max_seq, Hkv, dh), MLA configs
    ``ckv``/``krope`` (L, B, max_seq, ·). ``device`` defaults to the card;
    with no card it raises unless the caller passes ``device='cpu'``."""
    _check_dense(cfg)
    one = attn_mod.init_cache(cfg, batch, max_seq, dtype=dtype,
                              device=device)
    from repro_torch.runtime import layouts
    return dict(layers=layouts.stack_layers(one, cfg.n_layers))


def init_paged_cache_tree(cfg, batch: int, *, num_pages: int, page_size: int,
                          max_blocks: int, dtype=torch.bfloat16,
                          kv_dtype: Optional[str] = None, hot_window: int = 1,
                          device=None) -> dict:
    """One physical pool pair per layer (stacked over L; MLA configs: one
    latent pool ``cl``) and one set of block tables broadcast per layer (a
    view; ``with_block_tables`` refreshes it). ``kv_dtype='int8'`` adds
    the int8 cold tier per layer (``kq``/``vq`` (L, P, ps, Hkv, dh),
    ``ks``/``vs`` (L, P, Hkv) f32; MLA: ``clq`` (L, P, ps, r + d_rope),
    ``cs`` (L, P, 1)) and the hot window ``hw``, a (1,) int32 broadcast
    per layer like ``bt``.
    ``device`` defaults to the card; with no card it raises unless the
    caller passes ``device='cpu'``."""
    _check_dense(cfg)
    one = attn_mod.init_paged_cache(cfg, batch, num_pages=num_pages,
                                    page_size=page_size,
                                    max_blocks=max_blocks, dtype=dtype,
                                    kv_dtype=kv_dtype, hot_window=hot_window,
                                    device=device)
    from repro_torch.runtime import layouts
    return dict(layers=layouts.stack_layers(one, cfg.n_layers))


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------
def prefill(params: dict, batch: dict, cache: dict, cfg,
            yoco: YocoConfig = DEFAULT_YOCO, rt: ModelRuntime = DEFAULT_RT,
            last_pos=None) -> Tuple[torch.Tensor, dict]:
    """Process the prompt ``batch['inputs']`` (B, S), fill the cache, return
    the logits at ``last_pos`` (B,) (default: the last position)."""
    x = _embed(params, batch['inputs'], rt)
    x, cache = _backbone(params, x, cfg, yoco, rt, cache=cache,
                         decode_pos=None)
    if last_pos is None:
        x = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.int64,
                              device=x.device).reshape(-1)
        x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco)[:, 0], cache


def prefill_chunk(params: dict, batch: dict, offset, limit, cache: dict, cfg,
                  yoco: YocoConfig = DEFAULT_YOCO,
                  rt: ModelRuntime = DEFAULT_RT) -> Tuple[torch.Tensor, dict]:
    """Process ONE C-token chunk of a longer prompt into a paged cache.

    ``batch['inputs']``: the chunk's (B, C) tokens; ``offset``/``limit``:
    (B,) int32 — the chunk covers absolute positions
    [offset, min(offset + C, limit)); rows past ``limit`` are padding
    (written to the garbage page). Earlier chunks and shared prefix pages
    are already in the cache, so chunk k attends [0, offset_k + C) as a
    monolithic prefill would. Returns the logits of the chunk row holding
    position ``limit - 1`` (meaningful on the final chunk only) and the
    cache."""
    x = _embed(params, batch['inputs'], rt)
    b, c = x.shape[:2]
    offset = torch.as_tensor(offset, dtype=torch.int32,
                             device=x.device).reshape(-1).expand(b)
    limit = torch.as_tensor(limit, dtype=torch.int32,
                            device=x.device).reshape(-1).expand(b)
    x, cache = _backbone(params, x, cfg, yoco, rt, cache=cache,
                         decode_pos=None,
                         chunk_ctx=dict(offset=offset, limit=limit))
    idx = torch.clamp(limit - 1 - offset, 0, c - 1).to(torch.int64)
    x = x[torch.arange(b, device=x.device), idx][:, None]
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco)[:, 0], cache


def decode_step(params: dict, token: torch.Tensor, pos, cache: dict, cfg,
                yoco: YocoConfig = DEFAULT_YOCO,
                rt: ModelRuntime = DEFAULT_RT) -> Tuple[torch.Tensor, dict]:
    """One decode step: ``token`` (B,) int, ``pos`` 0-d or (B,) positions."""
    x = _embed(params, token[:, None], rt)
    x, cache = _backbone(params, x, cfg, yoco, rt, cache=cache,
                         decode_pos=pos)
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco)[:, 0], cache
