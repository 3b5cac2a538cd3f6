"""GQA attention and DeepSeek MLA (multi-head latent attention, absorbed
decode) over a paged or contiguous KV cache (port of
``repro/models/attention.py``, with its sequence-parallel MLA core
``_mla_sdpa_latent_2d``).

All projections route through ``core.yoco_linear``; q and k rotate by RoPE,
or by M-RoPE's (t, h, w) sections on an ``mrope`` config (qwen2-vl, a text
stream's positions feeding all three). Prompt attention is the
``_sdpa`` einsum (the reference has no kernel there). Decode reads the
cache either through the layout's densify view plus ``sdpa_decode`` (the
``einsum`` route, the oracle) or through the layout's flash kernel
(``rt.attn_impl == 'flash'``: K1, K6 over the int8 tier, or K7 over a
contiguous cache); a chunked
prefill (``attention_chunk``) reads it through the fp densify view or
kernel K5. MLA caches hold one latent row ``ckv ‖ krope`` (r + d_rope
values) per token: decode absorbs ``W_uk`` into the query and reads the
latent pool through the einsum oracle (:func:`mla_absorbed_attend`) or
kernel K8 (K10 over the int8 latent tier); a chunk reads it through K9;
``W_uv`` is applied once, to the f32 latent output. Cache dicts are
classified by ``runtime.layouts`` only; this module never looks at their
leaves.

Under head-parallel serving TP (``rt.tp_group`` set) a rank holds its
contiguous slice of the heads: head counts come from the projection
widths, never from the config, and :func:`_tp_heads_gather` reassembles
the head-major activation before the replicated ``wo``, the one
collective of a layer, at each of the six sites (prompt, decode and chunk,
GQA and MLA).

On a training rank mesh (``rt.mesh``; ``runtime/train_step.py``) the
'tp' layout gives a rank its whole heads of q/k/v (MLA: of ``w_uq`` and
``w_ukv``) and their rows of ``wo``: the replicated input enters through
``collectives.copy_in`` and ``wo`` is a row-parallel linear summed over
'model'. Under the '2d' layout a rank holds its rows of the sequence:
GQA gathers K/V over 'model', MLA its latent (:func:`_mla_sdpa_latent_2d`),
and its queries attend at their own offset.

Serving on a mesh (``runtime/serve_step.py::sharded_decode_step``) the
same 'tp' blocks serve a static cache a rank holds a block of: its KV
heads (the attention is the rank's own, K7 under ``attn_impl='flash'``,
``wo`` row-parallel), or its block of the sequence (``rt.kv_seq_axes``:
a prefill writes the prompt rows that fall in it, a decode token lands
only on the rank whose block holds it, and each rank scores its keys and
merges its partial max and sums with the others',
:func:`sdpa_decode_blocks`, MLA's :func:`mla_absorbed_blocks`).

Pools are written in place (see ``runtime/layouts.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.core import yoco_linear
from repro_torch.distributed import collectives
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import dense_init, keep, rmsnorm

NEG_INF = -2.0e38


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg, *, device, leaf=keep) -> dict:
    """``leaf(name, w)`` takes each f32 weight right after its draw."""
    d, h, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    p = dict(wq=leaf('wq', dense_init(gen, d, h * dh, device=device)),
             wk=leaf('wk', dense_init(gen, d, hkv * dh, device=device)),
             wv=leaf('wv', dense_init(gen, d, hkv * dh, device=device)),
             wo=leaf('wo', dense_init(gen, h * dh, d, device=device)))
    if cfg.attn_bias:
        for name, width in (('bq', h * dh), ('bk', hkv * dh),
                            ('bv', hkv * dh)):
            p[name] = torch.zeros((width,), dtype=torch.float32,
                                  device=device)
    if cfg.qk_norm:
        p['q_norm'] = torch.zeros((dh,), dtype=torch.float32, device=device)
        p['k_norm'] = torch.zeros((dh,), dtype=torch.float32, device=device)
    return p


def init_mla(gen: torch.Generator, cfg, *, device, leaf=keep) -> dict:
    """``leaf(name, w)`` takes each f32 weight right after its draw."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    return dict(
        w_dq=leaf('w_dq', dense_init(gen, d, m.q_lora_rank, device=device)),
        w_uq=leaf('w_uq', dense_init(
            gen, m.q_lora_rank, h * (m.nope_head_dim + m.rope_head_dim),
            device=device)),
        w_dkv=leaf('w_dkv', dense_init(
            gen, d, m.kv_lora_rank + m.rope_head_dim, device=device)),
        w_ukv=leaf('w_ukv', dense_init(
            gen, m.kv_lora_rank, h * (m.nope_head_dim + m.v_head_dim),
            device=device)),
        wo=leaf('wo', dense_init(gen, h * m.v_head_dim, d, device=device)),
        q_ln=torch.zeros((m.q_lora_rank,), dtype=torch.float32,
                         device=device),
        kv_ln=torch.zeros((m.kv_lora_rank,), dtype=torch.float32,
                          device=device))


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Empty contiguous KV cache: ``k``/``v`` (B, max_seq, Hkv, dh), or for
    MLA configs the latent rows ``ckv`` (B, max_seq, r) and ``krope``
    (B, max_seq, d_rope). ``device`` defaults to the card; with no card it
    raises unless the caller passes ``device='cpu'``."""
    device = device_mod.resolve(device)
    if cfg.mla is not None:
        m = cfg.mla
        return dict(
            ckv=torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                            device=device),
            krope=torch.zeros((batch, max_seq, m.rope_head_dim), dtype=dtype,
                              device=device))
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def init_paged_cache(cfg, batch: int, *, num_pages: int, page_size: int,
                     max_blocks: int, dtype=torch.bfloat16,
                     kv_dtype: Optional[str] = None, hot_window: int = 1,
                     device=None) -> dict:
    """Empty paged KV cache: one pool pair (page 0 = garbage page) plus
    all-garbage block tables. ``kv_dtype='int8'`` adds the int8 cold tier
    (``runtime/kv_quant.py``): int8 pools, per-page per-head scales and the
    ``hot_window`` in pages (>= 1). MLA configs get the latent layout
    instead: one ``cl`` pool (P, page_size, r + d_rope) and, tiered, an
    int8 ``clq`` twin with ONE absmax scale per page (``cs`` (P, 1)).
    ``device`` defaults to the card; with no card it raises unless the
    caller passes ``device='cpu'``."""
    if kv_dtype not in (None, 'fp', 'int8'):
        raise ValueError(f'kv_dtype must be None/"fp"/"int8", got '
                         f'{kv_dtype!r}')
    tiered = kv_dtype == 'int8'
    if tiered and hot_window < 1:
        raise ValueError('hot_window must be >= 1: the page being written '
                         'is always full-precision')
    device = device_mod.resolve(device)
    if cfg.mla is not None:
        m = cfg.mla
        shape = (num_pages, page_size, m.kv_lora_rank + m.rope_head_dim)
        cache = dict(cl=torch.zeros(shape, dtype=dtype, device=device),
                     bt=torch.zeros((batch, max_blocks), dtype=torch.int32,
                                    device=device))
        if tiered:
            cache.update(
                clq=torch.zeros(shape, dtype=torch.int8, device=device),
                cs=torch.zeros((num_pages, 1), dtype=torch.float32,
                               device=device),
                hw=torch.full((1,), hot_window, dtype=torch.int32,
                              device=device))
        return cache
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (num_pages, page_size, hkv, dh)
    cache = dict(k=torch.zeros(shape, dtype=dtype, device=device),
                 v=torch.zeros(shape, dtype=dtype, device=device),
                 bt=torch.zeros((batch, max_blocks), dtype=torch.int32,
                                device=device))
    if tiered:
        cache.update(
            kq=torch.zeros(shape, dtype=torch.int8, device=device),
            vq=torch.zeros(shape, dtype=torch.int8, device=device),
            ks=torch.zeros((num_pages, hkv), dtype=torch.float32,
                           device=device),
            vs=torch.zeros((num_pages, hkv), dtype=torch.float32,
                           device=device),
            hw=torch.full((1,), hot_window, dtype=torch.int32,
                          device=device))
    return cache


# ----------------------------------------------------------------------------
# masks
# ----------------------------------------------------------------------------
def causal_mask(sq: int, skv: int, offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """(sq, skv) additive mask; ``window`` keeps keys in
    [pos_q - window + 1, pos_q]."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF)


def decode_mask(pos: torch.Tensor, smax: int, window=None) -> torch.Tensor:
    """Length mask for single-token decode: ``pos`` 0-d -> (1, smax);
    ``pos`` (B,) -> (B, smax)."""
    kpos = torch.arange(smax, device=pos.device)
    if pos.ndim == 0:
        ok = kpos <= pos
        if window is not None:
            ok &= kpos > pos - window
        return torch.where(ok, 0.0, NEG_INF)[None, :]
    p = pos[:, None]
    ok = kpos[None, :] <= p
    if window is not None:
        w = torch.as_tensor(window, device=pos.device)
        w = w[:, None] if w.ndim else w
        ok &= kpos[None, :] > p - w
    return torch.where(ok, 0.0, NEG_INF)


def chunk_mask(offset, c: int, smax: int, window=None) -> torch.Tensor:
    """(B, C, smax) additive causal mask for a prefill chunk whose C query
    rows sit at absolute positions offset[b] .. offset[b] + C - 1 against a
    length-``smax`` densified cache view. Rows past the prompt length mask
    like real rows (their outputs are discarded)."""
    offset = torch.as_tensor(offset, dtype=torch.int64)
    qp = (offset.reshape(-1, 1, 1)
          + torch.arange(c, device=offset.device)[None, :, None])
    kpos = torch.arange(smax, device=offset.device)[None, None, :]
    ok = kpos <= qp
    if window is not None:
        ok &= kpos > qp - window
    return torch.where(ok, 0.0, NEG_INF)


# ----------------------------------------------------------------------------
# core attention math
# ----------------------------------------------------------------------------
def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], scale) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hkv, dh), H % Hkv == 0. Products in
    f32 on the operands as given (the reference's bf16 operands with f32
    accumulation), softmax in f32, probabilities cast to v's dtype."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh).to(torch.float32)
    logits = torch.einsum('bqkgd,bskd->bkgqs', qg,
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bkgqs,bskd->bqkgd',
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, h, dh).to(v.dtype)


def sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                scale: float, window=None) -> torch.Tensor:
    """Single-token decode attention via the einsum path (the oracle the
    flash kernel is held against). q (B, 1, H, dh); k/v (B, S_max, Hkv, dh);
    pos 0-d or (B,)."""
    pos = torch.as_tensor(pos, device=q.device)
    mask = decode_mask(pos, k.shape[1], window)
    if pos.ndim != 0:
        mask = mask[:, None, None, None, :]
    return _sdpa(q, k, v, mask, scale)


# ----------------------------------------------------------------------------
# a mesh rank's block of a static cache's sequence (sharded serving)
# ----------------------------------------------------------------------------
def _kv_block(layout, cache: dict, rt):
    """(lo, group): the first position of this rank's block of the cache's
    sequence and the group the sequence is cut over, or (None, None)
    where the rank holds the whole sequence."""
    group = None if rt is None else rt.kv_seq_group()
    if group is None:
        return None, None
    return rt.kv_seq_offset(layout.seq_len(cache)), group


def _write_prefill(layout, cache: dict, updates: dict, rt) -> dict:
    """The prompt's rows into the cache: a rank holding a block of the
    sequence writes the prompt rows that fall in it."""
    lo, _ = _kv_block(layout, cache, rt)
    if lo is not None:
        n = layout.seq_len(cache)
        updates = {k: u[:, lo:lo + n] for k, u in updates.items()}
    return layout.write_prefill(cache, updates)


def _write_token(layout, cache: dict, updates: dict, pos, rt) -> dict:
    """A decode token's row into the cache: only the rank whose block
    holds ``pos`` writes it."""
    lo, _ = _kv_block(layout, cache, rt)
    if lo is None:
        return layout.write_token(cache, updates, pos)
    return layout.write_token(cache, updates, pos, lo=lo)


def _merge_blocks(logits: torch.Tensor, values, group) -> torch.Tensor:
    """The softmax over keys cut into blocks over ``group``'s ranks, each
    rank's ``logits`` (..., S_block) masked for its block: the max over
    every block (one all-reduce MAX), each block's exponentials, and the
    sums ``values(p)`` (..., dv) and ``sum(p)`` added over the blocks (one
    all-reduce SUM of both), then divided. f32."""
    m = collectives.all_reduce(logits.amax(dim=-1, keepdim=True), group,
                               collectives.dist.ReduceOp.MAX)
    p = torch.exp(logits - m)
    packed = collectives.all_reduce(
        torch.cat([values(p), p.sum(dim=-1, keepdim=True)], dim=-1), group)
    return packed[..., :-1] / packed[..., -1:]


def sdpa_decode_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, scale, window, lo: int, group) -> torch.Tensor:
    """:func:`sdpa_decode` over a rank's block of the keys, positions
    [lo, lo + S_block), merged over ``group`` (:func:`_merge_blocks`). q
    (B, 1, H, dh); k/v (B, S_block, Hkv, dh); returns (B, 1, H, dh) in v's
    dtype."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, 1, hkv, h // hkv, dh).to(f32)
    logits = torch.einsum('bqkgd,bskd->bkgqs', qg, k.to(f32)) * scale
    pos = torch.as_tensor(pos, device=q.device)
    mask = decode_mask(pos - lo, k.shape[1], window)
    if pos.ndim != 0:
        mask = mask[:, None, None, None, :]
    out = _merge_blocks(logits + mask, lambda p: torch.einsum(
        'bkgqs,bskd->bkgqd', p, v.to(f32)), group)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh).to(v.dtype)


def mla_absorbed_blocks(q_lat, q_rope, ckv, krope, pos, scale, lo: int,
                        group) -> torch.Tensor:
    """:func:`mla_absorbed_attend` over a rank's block of the latent rows,
    positions [lo, lo + S_block), merged over ``group``: the (B, 1, H, r)
    f32 latent output."""
    f32 = torch.float32
    lo_ = torch.einsum('bqhr,bsr->bhqs', q_lat.to(f32), ckv.to(f32))
    lo_ = lo_ + torch.einsum('bqhd,bsd->bhqs', q_rope.to(f32),
                             krope.to(f32))
    pos = torch.as_tensor(pos, device=q_lat.device)
    mask = decode_mask(pos - lo, ckv.shape[1])
    if pos.ndim != 0:
        mask = mask[:, None, None, :]
    out = _merge_blocks(lo_ * scale + mask, lambda p: torch.einsum(
        'bhqs,bsr->bhqr', p, ckv.to(f32)), group)
    return out.permute(0, 2, 1, 3)


# ----------------------------------------------------------------------------
# GQA forward (prefill / decode)
# ----------------------------------------------------------------------------
def _tp_heads_gather(out_flat: torch.Tensor, rt) -> torch.Tensor:
    """The one collective of the TP serving path: every rank holds the
    attention outputs of its own contiguous head slice, and a tiled
    all-gather on the flattened head dim rebuilds the full head-major
    (B, S, H*dh) activation before the replicated ``wo``. A concatenation
    of per-head outputs equals the one-device run bit for bit, where a sum
    of partial ``wo`` products would reassociate the float reduction.
    Without a group (``rt.tp_group`` None): the identity."""
    if rt is None or rt.tp_group is None:
        return out_flat
    return collectives.heads_all_gather(out_flat, rt.tp_group)


def _tp_ways(rt) -> int:
    """The tensor-parallel degree the heads are split over (1: none)."""
    if rt is None or rt.tp_group is None:
        return 1
    return rt.tp_group.size()


def _width(w) -> int:
    return yoco_linear.weight_shape(w)[-1]


def _head_block(rt, n_local: int, n_whole: int):
    """(rank, ways) of a rank's head block: ways = n_whole / n_local, the
    rank's index in its serving TP group or on the mesh's 'model' axis."""
    ways = n_whole // n_local
    if ways == 1:
        return 0, 1
    if rt.tp_group is not None:
        return rt.tp_group.rank(), ways
    return rt.mesh.index(rt.tp_axis), ways


def _train_group(rt, ways: int):
    """The 'model' group a training rank's head block is summed over
    (None: whole heads, or serving TP, which gathers heads instead)."""
    if ways == 1 or rt is None or rt.mesh is None:
        return None
    return rt.model_group()


def _positions(b: int, s: int, rt, device) -> torch.Tensor:
    """Default positions, from this rank's first row of the sequence."""
    pos = rope_mod.default_positions(b, s, device=device)
    return pos if rt is None else pos + rt.seq_offset(s)


def _project_qkv(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig,
                 positions: torch.Tensor, theta: float, rt=None):
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    rank, ways = ((0, 1) if rt is None else
                  _head_block(rt, _width(p['wq']), cfg.n_heads * dh))
    # one quantization of x for the three projections (w8a8)
    q, k, v = yoco_linear.column_linears(
        x, [p['wq'], p['wk'], p['wv']],
        [p.get('bq'), p.get('bk'), p.get('bv')], cfg=yoco, rank=rank,
        ways=ways)
    q = q.reshape(b, s, -1, dh)
    k = k.reshape(b, s, -1, dh)
    v = v.reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p['q_norm'])
        k = rmsnorm(k, p['k_norm'])
    if cfg.mrope:
        # a text stream's (B, S) positions feed all three sections
        if positions.ndim == 2:
            positions = torch.stack([positions] * 3, dim=-1)
        q = rope_mod.apply_mrope(q, positions, theta)
        k = rope_mod.apply_mrope(k, positions, theta)
    else:
        q = rope_mod.apply_rope(q, positions, theta, cfg.rope_fraction)
        k = rope_mod.apply_rope(k, positions, theta, cfg.rope_fraction)
    return q, k, v


def attention(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
              positions: Optional[torch.Tensor] = None,
              window: Optional[int] = None, theta: Optional[float] = None,
              cache: Optional[dict] = None, rt=None,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence attention; with ``cache`` (prefill) the K/V rows are
    written at [0, s). Returns (out, cache)."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    theta = theta if theta is not None else cfg.rope_theta
    if positions is None:
        positions = _positions(b, s, rt, x.device)
    group = _train_group(rt, cfg.n_heads * dh // _width(p['wq']))
    if group is not None:
        x = collectives.copy_in(x, group)
        if cfg.qk_norm:         # replicated, applied to the rank's heads
            p = dict(p, q_norm=collectives.copy_in(p['q_norm'], group),
                     k_norm=collectives.copy_in(p['k_norm'], group))
    q, k, v = _project_qkv(p, x, cfg, yoco, positions, theta, rt)
    if cache is not None:
        from repro_torch.runtime import layouts
        cache = _write_prefill(layouts.get_layout(cache), cache,
                               dict(k=k, v=v), rt)
    skv, offset = s, 0
    if rt is not None and rt.seq_sharded:
        # sequence-parallel: every rank's keys, this rank's queries
        k = collectives.gather(k, 1, rt.model_group())
        v = collectives.gather(v, 1, rt.model_group())
        skv, offset = k.shape[1], rt.seq_offset(s)
    mask = causal_mask(s, skv, offset, window, device=x.device)
    # the reference's scale is 1 / sqrt(dh) computed in f32
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                          device=x.device))
    out = _sdpa(q, k, v, mask, scale)
    out = _tp_heads_gather(out.reshape(b, s, -1), rt)
    out = yoco_linear.row_linear(out, p['wo'], yoco, group=group)
    return out, cache


def attention_decode(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                     cache: dict, pos: torch.Tensor,
                     window: Optional[int] = None,
                     theta: Optional[float] = None, rt=None,
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d); ``pos``: 0-d or (B,) absolute
    positions being generated. ``rt.attn_impl == 'flash'`` reads the cache
    through the layout's kernel (K1, K6 over the int8 tier, K7 over a
    contiguous cache); ``'einsum'`` through the layout's densify view."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    theta = theta if theta is not None else cfg.rope_theta
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos.reshape(-1, 1).expand(b, 1)
    # a rank's block of the heads: serving TP's, or a mesh rank's (its wo
    # rows then summed over 'model')
    ways = cfg.n_heads * dh // _width(p['wq'])
    group = _train_group(rt, ways)
    q, k, v = _project_qkv(p, x, cfg, yoco, positions, theta, rt)
    scale = 1.0 / float(dh) ** 0.5
    from repro_torch.runtime import layouts
    layout = layouts.get_layout(cache)
    posr = pos.reshape(-1).expand(b) if layout.paged else pos
    cache = _write_token(layout, cache, dict(k=k, v=v), posr, rt)
    lo, seq_group = _kv_block(layout, cache, rt)
    if seq_group is not None:
        kd, vd = layout.gather(cache, posr)
        out = sdpa_decode_blocks(q, kd, vd, posr, scale, window, lo,
                                 seq_group)
    elif rt is not None and rt.attn_impl == 'flash':
        out = layout.flash_decode(q, cache, posr, scale=scale, window=window,
                                  ways=ways)
    else:
        kd, vd = layout.gather(cache, posr)
        out = sdpa_decode(q, kd, vd, posr, scale, window)
    out = _tp_heads_gather(out.reshape(b, 1, -1), rt)
    out = yoco_linear.row_linear(out, p['wo'], yoco, group=group)
    return out, cache


def attention_chunk(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                    cache: dict, offset, limit, window: Optional[int] = None,
                    theta: Optional[float] = None, rt=None,
                    ) -> Tuple[torch.Tensor, dict]:
    """Chunked prefill: C tokens of a longer prompt at absolute positions
    offset[b] .. offset[b] + C - 1 attend everything already written into
    the paged cache (earlier chunks, shared prefix pages) plus the chunk
    itself. x: (B, C, d); ``offset``/``limit``: (B,) int32 — rows at
    positions >= limit are padding (written to the garbage page, outputs
    discarded by the caller). Reads go through the fp pools only:
    ``rt.attn_impl == 'flash'`` through kernel K5, ``'einsum'`` through the
    layout's fp densify view."""
    b, c, _ = x.shape
    dh = cfg.resolved_head_dim
    theta = theta if theta is not None else cfg.rope_theta
    offset = torch.as_tensor(offset, dtype=torch.int32,
                             device=x.device).reshape(-1)
    positions = offset[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, yoco, positions, theta, rt)
    scale = 1.0 / float(dh) ** 0.5
    from repro_torch.runtime import layouts
    layout = layouts.get_layout(cache)
    cache = layout.write_chunk(cache, dict(k=k, v=v), offset, limit)
    if rt is not None and rt.attn_impl == 'flash':
        out = layout.flash_chunk(q, cache, offset, limit, scale=scale,
                                 window=window, ways=_tp_ways(rt))
    else:
        kd, vd = layout.gather_fp(cache)
        mask = chunk_mask(offset, c, kd.shape[1], window)
        out = _sdpa(q, kd, vd, mask[:, None, None, :, :], scale)
    out = _tp_heads_gather(out.reshape(b, c, -1), rt)
    out = yoco_linear.linear(out, p['wo'], cfg=yoco)
    return out, cache


# ----------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ----------------------------------------------------------------------------
def _mla_scale(m) -> float:
    """The softmax scale of the absorbed paths, 1/sqrt(nope + rope) as a
    Python float (the reference's kernels take it as a static argument)."""
    return 1.0 / float(m.nope_head_dim + m.rope_head_dim) ** 0.5


def _mla_project(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig,
                 positions: torch.Tensor, rt=None, group=None):
    """(q_nope, roped q_rope) (B, S, H, .) from the low-rank query, and
    (ckv (B, S, r), roped krope (B, S, d_rope)), what the cache holds;
    ``w_dq`` and ``w_dkv`` share one quantization of x (w8a8). With a
    training ``group`` (a rank's heads of ``w_uq``) the replicated low-rank
    query and latent enter the rank's heads through ``copy_in``."""
    m = cfg.mla
    b, s, _ = x.shape
    dq, dkv = yoco_linear.linears(x, [p['w_dq'], p['w_dkv']], cfg=yoco)
    cq = rmsnorm(dq, p['q_ln'])
    ckv = rmsnorm(dkv[..., :m.kv_lora_rank], p['kv_ln'])
    krope = dkv[..., m.kv_lora_rank:]
    krope = rope_mod.apply_rope(krope[:, :, None, :], positions,
                                cfg.rope_theta)[:, :, 0, :]
    if group is not None:
        cq, ckv, krope = (collectives.copy_in(t, group)
                          for t in (cq, ckv, krope))
    hd = m.nope_head_dim + m.rope_head_dim
    rank, ways = ((0, 1) if rt is None else
                  _head_block(rt, _width(p['w_uq']), cfg.n_heads * hd))
    q = yoco_linear.column_linears(cq, [p['w_uq']], cfg=yoco, rank=rank,
                                   ways=ways)[0]
    q = q.reshape(b, s, -1, hd)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return (q_nope, rope_mod.apply_rope(q_rope, positions, cfg.rope_theta),
            ckv, krope)


def _mla_qkv_full(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig,
                  positions: torch.Tensor, rt=None, group=None):
    """Naive (non-absorbed) q/k/v for prefill: per-head k_nope and v
    expanded from the latent through ``w_ukv``."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope, ckv, krope = _mla_project(p, x, cfg, yoco, positions,
                                              rt, group)
    hd = m.nope_head_dim + m.v_head_dim
    rank, ways = ((0, 1) if rt is None else
                  _head_block(rt, _width(p['w_ukv']), cfg.n_heads * hd))
    kv = yoco_linear.column_linears(ckv, [p['w_ukv']], cfg=yoco, rank=rank,
                                    ways=ways)[0]
    kv = kv.reshape(b, s, -1, hd)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    return q_nope, q_rope, k_nope, krope, v, ckv


def mla_attention(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None, rt=None,
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA prefill: materializes per-head k/v for the prompt, caches only
    the latent rows ``ckv ‖ krope`` (written at [0, s)). The prompt
    attention is einsums, as in the reference (no kernel there)."""
    m = cfg.mla
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, rt, x.device)
    group = _train_group(rt, cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
                         // _width(p['w_uq']))
    if rt is not None and rt.seq_sharded and cache is None:
        q_nope, q_rope, ckv, krope = _mla_project(p, x, cfg, yoco,
                                                  positions)
        out = _mla_sdpa_latent_2d(q_nope, q_rope, ckv, krope, p['w_ukv'],
                                  cfg, rt)
        out = yoco_linear.linear(out.reshape(b, s, -1).to(x.dtype), p['wo'],
                                 cfg=yoco)
        return out, None
    q_nope, q_rope, k_nope, krope, v, ckv = _mla_qkv_full(
        p, x, cfg, yoco, positions, rt, group)
    if cache is not None:
        from repro_torch.runtime import layouts
        cache = _write_prefill(layouts.get_layout(cache), cache,
                               dict(ckv=ckv, krope=krope), rt)
    # the reference's scale is 1 / sqrt(nope + rope) computed in f32
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(m.nope_head_dim + m.rope_head_dim), dtype=torch.float32,
        device=x.device))
    mask = causal_mask(s, s, device=x.device)
    f32 = torch.float32
    lo = torch.einsum('bqhd,bshd->bhqs', q_nope.to(f32), k_nope.to(f32))
    lo = lo + torch.einsum('bqhd,bsd->bhqs', q_rope.to(f32), krope.to(f32))
    probs = torch.softmax(lo * scale + mask, dim=-1)
    out = torch.einsum('bhqs,bshd->bqhd', probs.to(v.dtype).to(f32),
                       v.to(f32))
    out = _tp_heads_gather(out.reshape(b, s, -1).to(x.dtype), rt)
    out = yoco_linear.row_linear(out, p['wo'], yoco, group=group)
    return out, cache


def _mla_sdpa_latent_2d(q_nope, q_rope, ckv, krope, w_ukv, cfg, rt):
    """MLA's sequence-parallel core (the reference's shard_map body): each
    rank all-gathers the (r + d_rope)-wide latent over 'model', expands
    K/V from it locally through the whole ``w_ukv``, and attends its own
    queries at its offset. The gather's backward reduce-scatters the
    latent's cotangent: the dK/dV reduction never runs at 2·H·dh width."""
    m = cfg.mla
    h = cfg.n_heads
    group = rt.model_group()
    f32 = torch.float32
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(m.nope_head_dim + m.rope_head_dim), dtype=f32,
        device=q_nope.device))
    ck_f = collectives.gather(ckv, 1, group)             # (b, s, r)
    kr_f = collectives.gather(krope, 1, group)
    w = w_ukv.reshape(m.kv_lora_rank, h,
                      m.nope_head_dim + m.v_head_dim).to(q_nope.dtype)
    kv = torch.einsum('bsr,rhd->bshd', ck_f.to(f32), w.to(f32)).to(
        q_nope.dtype)
    kn, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    lo = torch.einsum('bqhd,bshd->bhqs', q_nope.to(f32), kn.to(f32))
    lo = lo + torch.einsum('bqhd,bsd->bhqs', q_rope.to(f32), kr_f.to(f32))
    sl = q_nope.shape[1]
    mask = causal_mask(sl, ck_f.shape[1], rt.seq_offset(sl),
                       device=q_nope.device)
    probs = torch.softmax(lo * scale + mask, dim=-1)
    out = torch.einsum('bhqs,bshd->bqhd', probs.to(v.dtype).to(f32),
                       v.to(f32))
    return out.to(q_nope.dtype)


def mla_absorbed_attend(q_lat: torch.Tensor, q_rope: torch.Tensor,
                        ckv: torch.Tensor, krope: torch.Tensor, pos,
                        scale: float) -> torch.Tensor:
    """Absorbed latent-space decode attention — the einsum oracle kernels
    K8 and K10 are held against. q_lat (B, 1, H, r) (q_nope through
    ``W_uk``); q_rope (B, 1, H, d_rope); ckv/krope (B, S, r)/(B, S,
    d_rope) dense latent views; pos 0-d or (B,). Math in f32; returns the
    (B, 1, H, r) latent output, before ``W_uv``."""
    f32 = torch.float32
    lo = torch.einsum('bqhr,bsr->bhqs', q_lat.to(f32), ckv.to(f32))
    lo = lo + torch.einsum('bqhd,bsd->bhqs', q_rope.to(f32), krope.to(f32))
    pos = torch.as_tensor(pos, device=q_lat.device)
    mask = decode_mask(pos, ckv.shape[1])
    if pos.ndim != 0:
        mask = mask[:, None, None, :]               # lo is (b, h, q, s)
    probs = torch.softmax(lo * scale + mask, dim=-1)
    return torch.einsum('bhqs,bsr->bqhr', probs, ckv.to(f32))


def _absorb_weights(p: dict, m):
    """(W_uk, W_uv) as f32 (r, H, dn) / (r, H, dv) views of ``w_ukv``; int8
    codes resident (``QuantizedWeight``) are read dequantized: the
    reference's absorbed decode reads only a float master (and fails on
    the codes, so ``serve()`` refuses --prequantize on MLA), the mesh
    serve and the dry run read the codes' values."""
    w = yoco_linear._float_weight(p['w_ukv'])
    w = w.reshape(m.kv_lora_rank, -1,
                  m.nope_head_dim + m.v_head_dim).to(torch.float32)
    return w[..., :m.nope_head_dim], w[..., m.nope_head_dim:]


#: the leaf beside a TP rank's ``w_ukv`` that holds :func:`tp_uv_weight`
TP_UV_KEY = 'w_ukv_ways'


def tp_uv_weight(w_ukv: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """A TP rank's ``w_ukv`` (r, H/tp * (dn + dv)) in its place among
    zeros at the whole head count, (r, H * (dn + dv)) f32, row-major as
    :func:`_absorb_weights` leaves the whole ``w_ukv``: what
    :func:`_uv_product` reads under TP. ``distributed/sharding.py`` builds
    it once, when it cuts the rank's tree."""
    n = w_ukv.shape[1]
    full = torch.zeros((w_ukv.shape[0], n * tp), dtype=torch.float32,
                       device=w_ukv.device)
    full[:, rank * n:(rank + 1) * n] = w_ukv
    return full


def _uv_product(o_lat: torch.Tensor, w_uv: torch.Tensor, p: dict, m,
                rt) -> torch.Tensor:
    """The latent output (B, S, H', r) through ``W_uv`` (``w_uv``, from
    :func:`_absorb_weights`): (B, S, H', dv) f32, one product a head (a
    batched GEMM over the heads). Under TP the rank computes it at the
    whole head count: its heads' outputs among zeros, through
    ``p[TP_UV_KEY]`` (:func:`tp_uv_weight`), then its heads taken back.
    On the H100, cuBLAS picks the batched GEMM's algorithm from the batch
    count, and at a decode step's or a chunk's few rows (M = 8) the one it
    picks for 64 or 32 heads sums the r = 512 terms otherwise than the one
    for 128, so a rank's heads would differ from tp = 1's in the last bits
    (measured; ROADMAP Queue 3). The whole-count product, like the
    kernels' plans of ``ways``, keeps each head bit-equal, at tp times the
    product's work."""
    ways = _tp_ways(rt)
    if ways == 1:
        return torch.einsum('bqhr,rhd->bqhd', o_lat, w_uv)
    rank, h = rt.tp_group.rank(), o_lat.shape[2]
    pad = o_lat.new_zeros(o_lat.shape[:2] + (h * ways,) + o_lat.shape[3:])
    pad[:, :, rank * h:(rank + 1) * h] = o_lat
    _, w_uv = _absorb_weights(dict(w_ukv=p[TP_UV_KEY]), m)
    out = torch.einsum('bqhr,rhd->bqhd', pad, w_uv)
    return out[:, :, rank * h:(rank + 1) * h]


def mla_attention_decode(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                         cache: dict, pos, rt=None
                         ) -> Tuple[torch.Tensor, dict]:
    """Absorbed MLA decode: scores ``(q_nope @ W_uk) · ckv + q_rope ·
    krope`` and output ``(probs · ckv) @ W_uv``, per head, over the latent
    cache (r + d_rope values a token). ``rt.attn_impl == 'flash'`` reads a
    paged latent pool through the layout's kernel (K8, or K10 over the
    int8 tier), ``'einsum'`` through the layout's (tier-mixing) densify
    view and :func:`mla_absorbed_attend`. x: (B, 1, d); pos 0-d or
    (B,)."""
    m = cfg.mla
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos.reshape(-1, 1).expand(b, 1)
    q_nope, q_rope, ckv_t, krope_t = _mla_project(p, x, cfg, yoco,
                                                  positions, rt)
    w_uk, w_uv = _absorb_weights(p, m)
    q_lat = torch.einsum('bqhd,rhd->bqhr', q_nope.to(torch.float32), w_uk)
    scale = _mla_scale(m)
    r = m.kv_lora_rank
    from repro_torch.runtime import layouts
    layout = layouts.get_layout(cache)
    posr = pos.reshape(-1).expand(b) if layout.paged else pos
    # writes always land in the fp latent pool, tiered layout or not
    cache = _write_token(layout, cache, dict(ckv=ckv_t, krope=krope_t),
                         posr, rt)
    lo, seq_group = _kv_block(layout, cache, rt)
    if seq_group is not None:
        ckv_d, krope_d = layout.gather(cache, posr, r=r)
        o_lat = mla_absorbed_blocks(q_lat, q_rope, ckv_d, krope_d, posr,
                                    scale, lo, seq_group)
    elif rt is not None and rt.attn_impl == 'flash' and layout.paged:
        o_lat = layout.flash_decode(
            torch.cat([q_lat, q_rope.to(torch.float32)], -1), cache, posr,
            scale=scale, r=r, ways=_tp_ways(rt))
    else:
        ckv_d, krope_d = layout.gather(cache, posr, r=r)
        o_lat = mla_absorbed_attend(q_lat, q_rope, ckv_d, krope_d, posr,
                                    scale)
    out = _uv_product(o_lat, w_uv, p, m, rt)
    out = _tp_heads_gather(out.reshape(b, 1, -1).to(x.dtype), rt)
    out = yoco_linear.linear(out, p['wo'], cfg=yoco)
    return out, cache


def mla_attention_chunk(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                        cache: dict, offset, limit, rt=None
                        ) -> Tuple[torch.Tensor, dict]:
    """Chunked MLA prefill through the absorbed math: C tokens at absolute
    positions offset[b] .. offset[b] + C - 1 attend the paged latent cache
    (earlier chunks, shared prefix pages, the chunk itself). Same contract
    as :func:`attention_chunk`: reads go through the fp latent pool only
    (kernel K9 under ``rt.attn_impl == 'flash'``), and ``W_uv`` is applied
    once, outside the softmax."""
    m = cfg.mla
    b, c, _ = x.shape
    offset = torch.as_tensor(offset, dtype=torch.int32,
                             device=x.device).reshape(-1)
    positions = offset[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=x.device)[None, :]
    q_nope, q_rope, ckv_t, krope_t = _mla_project(p, x, cfg, yoco,
                                                  positions, rt)
    w_uk, w_uv = _absorb_weights(p, m)
    f32 = torch.float32
    q_lat = torch.einsum('bqhd,rhd->bqhr', q_nope.to(f32), w_uk)
    scale = _mla_scale(m)
    r = m.kv_lora_rank
    from repro_torch.runtime import layouts
    layout = layouts.get_layout(cache)
    cache = layout.write_chunk(cache, dict(ckv=ckv_t, krope=krope_t),
                               offset, limit)
    if rt is not None and rt.attn_impl == 'flash' and layout.paged:
        o_lat = layout.flash_chunk(torch.cat([q_lat, q_rope.to(f32)], -1),
                                   cache, offset, limit, scale=scale, r=r,
                                   ways=_tp_ways(rt))
    else:
        ckv_d, krope_d = layout.gather_fp(cache, r=r)
        lo = torch.einsum('bqhr,bsr->bhqs', q_lat, ckv_d.to(f32))
        lo = lo + torch.einsum('bqhd,bsd->bhqs', q_rope.to(f32),
                               krope_d.to(f32))
        mask = chunk_mask(offset, c, ckv_d.shape[1])
        probs = torch.softmax(lo * scale + mask[:, None, :, :], dim=-1)
        o_lat = torch.einsum('bhqs,bsr->bqhr', probs, ckv_d.to(f32))
    out = _uv_product(o_lat, w_uv, p, m, rt)
    out = _tp_heads_gather(out.reshape(b, c, -1).to(x.dtype), rt)
    out = yoco_linear.linear(out, p['wo'], cfg=yoco)
    return out, cache
