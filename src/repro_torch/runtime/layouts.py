"""The cache-layout registry — the ONE place allowed to look at a cache
dict's leaves (port of ``repro/runtime/layouts.py``).

A cache dict is classified once (:func:`get_layout`, by leaf schema) and
the returned layout owns its write ops, its densify oracle and its kernel
entrypoint. Layouts ported so far (single layer; layer stacks prepend (L,)):

==================  ======================================================
PagedMLAQ8Layout    PagedMLALayout + ``clq`` (P, ps, r + d_rope) int8,
                    ``cs`` (P, 1) f32, ``hw`` (1,) int32
PagedMLALayout      ``cl`` (P, ps, r + d_rope), ``bt`` (B, W) int32
PagedQ8Layout       PagedLayout + ``kq``/``vq`` (P, ps, Hkv, dh) int8,
                    ``ks``/``vs`` (P, Hkv) f32, ``hw`` (1,) int32
PagedLayout         ``k``/``v`` (P, ps, Hkv, dh), ``bt`` (B, W) int32
ContiguousMLALayout ``ckv`` (B, S_max, r), ``krope`` (B, S_max, d_rope)
ContiguousLayout    ``k``/``v`` (B, S_max, Hkv, dh)
RecurrentLayout     ``conv`` (B, W_conv-1, C), ``ssm`` (B, H, P, N), f32
HybridLayout        ``ssm`` (a RecurrentLayout stack) + ``attn`` (a paged
                    or contiguous site stack); no ops of its own
==================  ======================================================

``hw`` is the hot window in pages (>= 1; >= W never reads the int8 tier;
see ``runtime/kv_quant.py``). An MLA latent row is ``ckv ‖ krope`` (one
pool, written together, scored together; the first r columns are the
values); its gathers and kernels take the latent rank ``r``. The
contiguous caches serve the static ``serve()`` path: GQA through kernel K7
or the einsum oracle, MLA through the einsum oracle only (as in the
reference, its flash kernels are paged). Recurrent state has no position
axis: its layout offers the continuous scheduler three slot ops instead
(:func:`reset_state_slots`, :func:`slice_state_slot`,
:func:`merge_state_slot`), and every tree walker passes recurrent nodes
through and recurses into a hybrid's ``attn``. Write ops, slot ops and
tree walkers update pools IN PLACE (the reference returns new arrays); the
returned dicts share the caller's tensors. Under head-parallel serving TP
each layout names the leaves that carry a head axis (``shard_dims``: GQA
pools and their int8 tiers on Hkv, the per-head scales on their head
axis), and :func:`stack_layers` allocates a rank's part of them, 1/tp of
that axis; everything else is replicated.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Type

import torch

from repro_torch.runtime import kv_cache as kvc
from repro_torch.runtime import kv_quant as kvq

_REGISTRY: List[Type['CacheLayout']] = []


def _register(cls):
    """Most-specific-first registry: classes registered earlier win."""
    _REGISTRY.append(cls)
    return cls


def get_layout(cache: dict) -> Type['CacheLayout']:
    """Classify a cache dict by its leaf schema; KeyError if none matches."""
    lay = match_layout(cache)
    if lay is None:
        raise KeyError(f'no registered cache layout matches leaves '
                       f'{sorted(cache)}; known layouts: '
                       f'{[c.name for c in _REGISTRY]}')
    return lay


def match_layout(cache: dict) -> Optional[Type['CacheLayout']]:
    keys = set(cache)
    for cls in _REGISTRY:
        if cls.required <= keys:
            return cls
    return None


def _pos_vec(pos, b: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return pos.expand(b) if pos.numel() == 1 else pos


def dense_token_update(c: torch.Tensor, t: torch.Tensor, pos,
                       lo: Optional[int] = None) -> torch.Tensor:
    """Write ``t`` (B, 1, ...) into a contiguous cache ``c`` (B, S_max, ...)
    at ``pos`` (scalar or (B,)). In place. With ``lo``, ``c`` is a block
    of a longer sequence holding positions [lo, lo + S_block) (a mesh
    rank's block), and a row is written only where its position falls in
    them, with no host read of ``pos``."""
    rows = torch.arange(c.shape[0], device=c.device)
    posv = _pos_vec(pos, c.shape[0], c.device).to(torch.int64)
    if lo is None:
        c[rows, posv] = t[:, 0].to(c.dtype)
        return c
    local = posv - lo
    own = (local >= 0) & (local < c.shape[1])
    idx = local.clamp(0, c.shape[1] - 1)
    new = t[:, 0].to(c.dtype)
    keep = own.reshape((-1,) + (1,) * (new.ndim - 1))
    c[rows, idx] = torch.where(keep, new, c[rows, idx])
    return c


def _latent_row(updates: dict) -> torch.Tensor:
    """MLA write slab: ckv ‖ krope, the one-pool row the latent layouts
    store."""
    return torch.cat([updates['ckv'], updates['krope']], dim=-1)


class CacheLayout:
    """One cache layout: leaf schema + write ops + densify oracle + kernel
    entrypoint, as classmethods over plain cache dicts."""

    name: str = ''
    required: frozenset = frozenset()
    paged: bool = False
    quantized: bool = False             # carries an int8 tier
    recurrent: bool = False             # per-slot state (slot ops)
    table_leaves: Tuple[str, ...] = ()  # refreshed by with_block_tables
    shared_leaves: Tuple[str, ...] = () # one copy broadcast over layers
    scrub_leaves: Tuple[str, ...] = ()  # zeroed by scrub_tree_pages
    poison_leaves: Tuple[str, ...] = () # fp pools (poison, zero_tree_tail)
    # head-parallel serving TP: leaf -> the dim of its single-layer shape
    # that carries the head axis. Leaves absent here are replicated (block
    # tables, hot windows, MLA latent pools, which have no head axis, and
    # recurrent state); see stack_layers
    shard_dims: dict = {}

    @classmethod
    def write_token(cls, cache: dict, updates: dict, pos) -> dict:
        raise NotImplementedError

    @classmethod
    def write_prefill(cls, cache: dict, updates: dict) -> dict:
        raise NotImplementedError

    @classmethod
    def write_chunk(cls, cache: dict, updates: dict, offset, limit) -> dict:
        """Write a prefill chunk's rows at [offset, offset + C); rows at or
        beyond ``limit`` go to the garbage page. Paged layouts only."""
        raise NotImplementedError(f'{cls.name} has no chunked-prefill path')

    @classmethod
    def gather(cls, cache: dict, pos):
        """Contiguous (k, v) views for the einsum oracle (``pos`` matters
        only to the tiered layout: hotness)."""
        raise NotImplementedError

    @classmethod
    def gather_fp(cls, cache: dict):
        """Full-precision densify ignoring any int8 tier — the chunked
        prefill's read path (pages just written are not quantized yet)."""
        return cls.gather(cache, 0)

    @classmethod
    def flash_decode(cls, q, cache: dict, pos, *, scale, window=None,
                     ways=1):
        """The layout's decode kernel. ``ways``: the tensor-parallel degree
        the heads were split over (the kernels plan their key split for
        the whole head count)."""
        raise NotImplementedError

    @classmethod
    def flash_chunk(cls, q, cache: dict, offset, limit, *, scale,
                    window=None, ways=1):
        """A chunked-prefill read (kernel K5) over the fp pools."""
        raise NotImplementedError(f'{cls.name} has no chunked-prefill path')

    @classmethod
    def quantize_pages(cls, cache: dict, pages) -> dict:
        raise NotImplementedError(
            f'{cls.name} has no int8 tier to quantize into')


@_register
class PagedMLAQ8Layout(CacheLayout):
    """Paged MLA latent pool plus its int8 cold tier: ``cl``/``clq``/
    ``cs``/``bt``/``hw``. Writes land in the fp ``cl`` pool; aged-out pages
    are quantized with one absmax scale per page, before the W_uk/W_uv
    expansion. Registered ahead of :class:`PagedMLALayout`, whose leaves
    it carries."""
    name = 'paged_mla_q8'
    required = frozenset({'cl', 'clq', 'cs', 'bt', 'hw'})
    paged = True
    quantized = True
    table_leaves = ('bt',)
    shared_leaves = ('bt', 'hw')
    scrub_leaves = ('cl', 'clq', 'cs')
    poison_leaves = ('cl',)

    @classmethod
    def write_token(cls, cache, updates, pos):
        return PagedMLALayout.write_token(cache, updates, pos)

    @classmethod
    def write_prefill(cls, cache, updates):
        return PagedMLALayout.write_prefill(cache, updates)

    @classmethod
    def write_chunk(cls, cache, updates, offset, limit):
        return PagedMLALayout.write_chunk(cache, updates, offset, limit)

    @classmethod
    def gather(cls, cache, pos, r=None):
        dense = kvq.dequant_gather_mla(
            cache, _pos_vec(pos, cache['bt'].shape[0], cache['bt'].device))
        return dense[..., :r], dense[..., r:]

    @classmethod
    def gather_fp(cls, cache, r=None):
        return PagedMLALayout.gather(cache, 0, r=r)

    @classmethod
    def flash_decode(cls, q, cache, pos, *, scale, window=None, r=None,
                     ways=1):
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_decode_paged_mla_q8(
            q, cache['cl'], cache['clq'], cache['cs'], pos, cache['bt'],
            cache['hw'], r=r, scale=scale, window=window, ways=ways)

    @classmethod
    def flash_chunk(cls, q, cache, offset, limit, *, scale, window=None,
                    r=None, ways=1):
        # fp pool only: earlier chunks' pages are not quantized yet
        return PagedMLALayout.flash_chunk(q, cache, offset, limit,
                                          scale=scale, window=window, r=r,
                                          ways=ways)

    @classmethod
    def quantize_pages(cls, cache, pages):
        return kvq.quantize_latent_pages_layer(cache, pages)


@_register
class PagedMLALayout(CacheLayout):
    """Paged MLA latent pool: one ``cl`` pool (ckv ‖ krope per row) and
    shared ``bt`` block tables."""
    name = 'paged_mla'
    required = frozenset({'cl', 'bt'})
    paged = True
    table_leaves = ('bt',)
    shared_leaves = ('bt',)
    scrub_leaves = ('cl',)
    poison_leaves = ('cl',)

    @classmethod
    def write_token(cls, cache, updates, pos):
        lat = _latent_row(updates)
        kvc.paged_token_update(cache['cl'], lat,
                               _pos_vec(pos, lat.shape[0], lat.device),
                               cache['bt'])
        return cache

    @classmethod
    def write_prefill(cls, cache, updates):
        kvc.paged_prefill_update(cache['cl'], _latent_row(updates),
                                 cache['bt'])
        return cache

    @classmethod
    def write_chunk(cls, cache, updates, offset, limit):
        kvc.paged_chunk_update(cache['cl'], _latent_row(updates), offset,
                               limit, cache['bt'])
        return cache

    @classmethod
    def gather(cls, cache, pos, r=None):
        del pos
        dense = kvc.gather_pages(cache['cl'], cache['bt'])
        return dense[..., :r], dense[..., r:]

    @classmethod
    def gather_fp(cls, cache, r=None):
        return cls.gather(cache, 0, r=r)

    @classmethod
    def flash_decode(cls, q, cache, pos, *, scale, window=None, r=None,
                     ways=1):
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_decode_paged_mla(q, cache['cl'], pos, cache['bt'],
                                         r=r, scale=scale, window=window,
                                         ways=ways)

    @classmethod
    def flash_chunk(cls, q, cache, offset, limit, *, scale, window=None,
                    r=None, ways=1):
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_chunk_paged_mla(q, cache['cl'], offset, limit,
                                        cache['bt'], r=r, scale=scale,
                                        window=window, ways=ways)


@_register
class PagedQ8Layout(CacheLayout):
    """Paged GQA pools plus the int8 cold tier: ``k``/``v``/``kq``/``vq``/
    ``ks``/``vs``/``bt``/``hw``. Writes land in the fp pools; aged-out
    pages are quantized per page and per KV head. Registered ahead of
    :class:`PagedLayout`, whose leaves it carries."""
    name = 'paged_q8'
    required = frozenset({'k', 'v', 'kq', 'vq', 'ks', 'vs', 'bt', 'hw'})
    paged = True
    quantized = True
    table_leaves = ('bt',)
    shared_leaves = ('bt', 'hw')
    scrub_leaves = ('k', 'v', 'kq', 'vq', 'ks', 'vs')
    poison_leaves = ('k', 'v')
    # pools split the Hkv axis; the per-page per-head scales follow it
    shard_dims = {'k': 2, 'v': 2, 'kq': 2, 'vq': 2, 'ks': 1, 'vs': 1}

    @classmethod
    def write_token(cls, cache, updates, pos):
        return PagedLayout.write_token(cache, updates, pos)

    @classmethod
    def write_prefill(cls, cache, updates):
        return PagedLayout.write_prefill(cache, updates)

    @classmethod
    def write_chunk(cls, cache, updates, offset, limit):
        return PagedLayout.write_chunk(cache, updates, offset, limit)

    @classmethod
    def gather(cls, cache, pos):
        return kvq.dequant_gather(cache, _pos_vec(pos, cache['bt'].shape[0],
                                                  cache['bt'].device))

    @classmethod
    def gather_fp(cls, cache):
        return PagedLayout.gather(cache, 0)

    @classmethod
    def flash_decode(cls, q, cache, pos, *, scale, window=None, ways=1):
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_decode_paged_q8(
            q, cache['k'], cache['v'], cache['kq'], cache['vq'],
            cache['ks'], cache['vs'], pos, cache['bt'], cache['hw'],
            scale=scale, window=window, ways=ways)

    @classmethod
    def flash_chunk(cls, q, cache, offset, limit, *, scale, window=None,
                    ways=1):
        # fp pools only: earlier chunks' pages are not quantized yet
        return PagedLayout.flash_chunk(q, cache, offset, limit, scale=scale,
                                       window=window, ways=ways)

    @classmethod
    def quantize_pages(cls, cache, pages):
        return kvq.quantize_pages_layer(cache, pages)


@_register
class PagedLayout(CacheLayout):
    """Paged GQA pools: ``k``/``v`` pools + shared ``bt`` block tables."""
    name = 'paged'
    required = frozenset({'k', 'v', 'bt'})
    paged = True
    table_leaves = ('bt',)
    shared_leaves = ('bt',)
    scrub_leaves = ('k', 'v')
    poison_leaves = ('k', 'v')
    shard_dims = {'k': 2, 'v': 2}       # (P, ps, Hkv, dh): split Hkv

    @classmethod
    def write_token(cls, cache, updates, pos):
        posv = _pos_vec(pos, updates['k'].shape[0], cache['k'].device)
        kvc.paged_token_update(cache['k'], updates['k'], posv, cache['bt'])
        kvc.paged_token_update(cache['v'], updates['v'], posv, cache['bt'])
        return cache

    @classmethod
    def write_prefill(cls, cache, updates):
        kvc.paged_prefill_update(cache['k'], updates['k'], cache['bt'])
        kvc.paged_prefill_update(cache['v'], updates['v'], cache['bt'])
        return cache

    @classmethod
    def gather(cls, cache, pos):
        del pos
        return (kvc.gather_pages(cache['k'], cache['bt']),
                kvc.gather_pages(cache['v'], cache['bt']))

    @classmethod
    def write_chunk(cls, cache, updates, offset, limit):
        kvc.paged_chunk_update(cache['k'], updates['k'], offset, limit,
                               cache['bt'])
        kvc.paged_chunk_update(cache['v'], updates['v'], offset, limit,
                               cache['bt'])
        return cache

    @classmethod
    def flash_decode(cls, q, cache, pos, *, scale, window=None, ways=1):
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_decode_paged(q, cache['k'], cache['v'], pos,
                                     cache['bt'], scale=scale, window=window,
                                     ways=ways)

    @classmethod
    def flash_chunk(cls, q, cache, offset, limit, *, scale, window=None,
                    ways=1):
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_chunk_paged(q, cache['k'], cache['v'], offset, limit,
                                    cache['bt'], scale=scale, window=window,
                                    ways=ways)


@_register
class ContiguousMLALayout(CacheLayout):
    """Contiguous MLA latent cache: ``ckv``/``krope`` (B, S_max, ·). The
    einsum-only decode layout (the MLA flash kernels are paged: serve long
    contexts through ``--continuous``)."""
    name = 'contiguous_mla'
    required = frozenset({'ckv', 'krope'})

    @classmethod
    def write_token(cls, cache, updates, pos, lo=None):
        dense_token_update(cache['ckv'], updates['ckv'], pos, lo)
        dense_token_update(cache['krope'], updates['krope'], pos, lo)
        return cache

    @classmethod
    def seq_len(cls, cache):
        return cache['ckv'].shape[1]

    @classmethod
    def write_prefill(cls, cache, updates):
        s = updates['ckv'].shape[1]
        cache['ckv'][:, :s] = updates['ckv'].to(cache['ckv'].dtype)
        cache['krope'][:, :s] = updates['krope'].to(cache['krope'].dtype)
        return cache

    @classmethod
    def gather(cls, cache, pos, r=None):
        del pos, r
        return cache['ckv'], cache['krope']


@_register
class ContiguousLayout(CacheLayout):
    """Contiguous GQA cache: ``k``/``v`` (B, S_max, Hkv, dh)."""
    name = 'contiguous'
    required = frozenset({'k', 'v'})

    @classmethod
    def write_token(cls, cache, updates, pos, lo=None):
        dense_token_update(cache['k'], updates['k'], pos, lo)
        dense_token_update(cache['v'], updates['v'], pos, lo)
        return cache

    @classmethod
    def seq_len(cls, cache):
        return cache['k'].shape[1]

    @classmethod
    def write_prefill(cls, cache, updates):
        s = updates['k'].shape[1]
        cache['k'][:, :s] = updates['k'].to(cache['k'].dtype)
        cache['v'][:, :s] = updates['v'].to(cache['v'].dtype)
        return cache

    @classmethod
    def gather(cls, cache, pos):
        del pos
        return cache['k'], cache['v']

    @classmethod
    def flash_decode(cls, q, cache, pos, *, scale, window=None, ways=1):
        # ways > 1: a mesh rank's block of the heads (sharded serving)
        from repro_torch.kernels import flash_decode as fd
        return fd.flash_decode(q, cache['k'], cache['v'], pos, scale=scale,
                               window=window, ways=ways)


@_register
class RecurrentLayout(CacheLayout):
    """Per-slot recurrent state: ``conv`` (B, W_conv-1, C) and ``ssm``
    (B, H, P, N). No positional axis (the whole state is rewritten every
    token), so instead of write and gather ops the layout offers the three
    slot ops the continuous scheduler needs (reset, snapshot, restore),
    delegated to ``models.ssm``, on single or (L,)-stacked dicts (the
    batch axis found from ``conv``'s ndim)."""
    name = 'recurrent'
    required = frozenset({'conv', 'ssm'})
    recurrent = True
    state_probe = 'conv'
    state_probe_ndim = 3        # (B, W_conv-1, C); stacks prepend (L,)

    @classmethod
    def _axis(cls, cache: dict) -> int:
        return cache[cls.state_probe].ndim - cls.state_probe_ndim

    @classmethod
    def slot_reset(cls, cache, slots):
        from repro_torch.models import ssm as ssm_mod
        return ssm_mod.slot_reset(cache, slots, axis=cls._axis(cache))

    @classmethod
    def slot_snapshot(cls, cache, slot):
        from repro_torch.models import ssm as ssm_mod
        return ssm_mod.slot_snapshot(cache, slot, axis=cls._axis(cache))

    @classmethod
    def slot_restore(cls, cache, snap, slot):
        from repro_torch.models import ssm as ssm_mod
        return ssm_mod.slot_restore(cache, snap, slot,
                                    axis=cls._axis(cache))


@_register
class HybridLayout(CacheLayout):
    """Structural marker of a hybrid (attention + SSM) cache tree: ``ssm``
    (a RecurrentLayout stack) and ``attn`` (a paged or contiguous site
    stack). No ops of its own: the walkers recurse into both members, and
    each classifies to its own layout."""
    name = 'hybrid'
    required = frozenset({'ssm', 'attn'})


# ----------------------------------------------------------------------------
# tree walkers (layer-stacked cache trees)
# ----------------------------------------------------------------------------
def stack_layers(cache: dict, n: int, tp: int = 1) -> dict:
    """A layer stack of ``n`` copies of the single-layer cache dict: own
    zeroed pools per layer, and the layout's shared leaves (block tables,
    hot window) broadcast over the layer dim as a view. ``tp`` > 1
    allocates a head-parallel rank's part: each leaf the layout names in
    :attr:`~CacheLayout.shard_dims` at 1/tp of its head axis (the pools
    start zeroed, so every rank's part is the same), every other leaf
    whole."""
    lay = get_layout(cache)

    def shape(key, leaf):
        s = list(leaf.shape)
        if tp > 1 and key in lay.shard_dims:
            s[lay.shard_dims[key]] //= tp
        return (n,) + tuple(s)
    return {key: (leaf[None].expand((n,) + leaf.shape)
                  if key in lay.shared_leaves
                  else torch.zeros(shape(key, leaf), dtype=leaf.dtype,
                                   device=leaf.device))
            for key, leaf in cache.items()}


def with_block_tables(cache_tree, tables, hot_window=None):
    """Refresh every paged layout's table leaves with ``tables`` (B, W),
    broadcast (a view, no copy) over each leaf's leading layer dim.
    ``hot_window`` (optional int) also rewrites every ``hw`` copy of the
    tiered layouts, with the same broadcast."""
    tables = torch.as_tensor(tables, dtype=torch.int32)

    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            out = {}
            for key, val in node.items():
                if lay is not None and key in lay.table_leaves:
                    t = tables.to(val.device)
                    out[key] = t[None].expand((val.shape[0],) + t.shape)
                elif (lay is not None and lay.quantized and key == 'hw'
                        and hot_window is not None):
                    hw = torch.tensor([hot_window], dtype=torch.int32,
                                      device=val.device)
                    out[key] = hw[None].expand(val.shape[0], 1)
                else:
                    out[key] = walk(val)
            return out
        return node

    return walk(cache_tree)


def quantize_tree_pages(cache_tree, pages) -> dict:
    """Apply each quantized layout's :meth:`~CacheLayout.quantize_pages` to
    every matching node of a (possibly layer-stacked) cache tree. Page
    indices are physical, so one vector covers every layer. In place."""
    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.quantized:
                return lay.quantize_pages(node, pages)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def copy_tree_pages(cache_tree, src: int, dst: int) -> dict:
    """Copy one physical page ``src`` onto ``dst`` in every per-page leaf
    (fp pools, int8 tiers, scales) of every paged node — the copy-on-write
    split of a fully covered shared prefix. In place."""
    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.scrub_leaves:
                stacked = node[lay.table_leaves[0]].ndim == 3
                for key in lay.scrub_leaves:
                    leaf = node[key]
                    if stacked:
                        leaf[:, dst] = leaf[:, src]
                    else:
                        leaf[dst] = leaf[src]
                return node
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def scrub_tree_pages(cache_tree, pages) -> dict:
    """Zero the given physical pages in every per-page leaf of every paged
    node (the quarantine scrub: a NaN row left in a pool would poison the
    page's next tenant through the additive mask). In place."""
    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.scrub_leaves:
                idx = torch.as_tensor(pages, dtype=torch.int64,
                                      device=node[lay.scrub_leaves[0]].device)
                stacked = node[lay.table_leaves[0]].ndim == 3
                for key in lay.scrub_leaves:
                    if stacked:
                        node[key][:, idx] = 0
                    else:
                        node[key][idx] = 0
                return node
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def poison_tree_pages(cache_tree, pages, value=float('nan')) -> dict:
    """Write ``value`` (NaN by default) into the given physical pages of
    every paged node's fp pools (``poison_leaves``): the chaos layer's
    model of a corrupted in-memory read. An int8 tier cannot hold NaN, so
    it is never touched (:func:`scrub_tree_pages` zeroes it too). In
    place."""
    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.poison_leaves:
                idx = torch.as_tensor(pages, dtype=torch.int64,
                                      device=node[lay.poison_leaves[0]].device)
                stacked = node[lay.table_leaves[0]].ndim == 3
                for key in lay.poison_leaves:
                    if stacked:
                        node[key][:, idx] = value
                    else:
                        node[key][idx] = value
                return node
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def zero_tree_tail(cache_tree, table_row, start: int, stop: int) -> dict:
    """Zero the logical rows [start, stop) of one request's pages in every
    paged node's fp pools, following its block-table row (W,). Rows outside
    the range redirect onto the garbage page. In place."""
    def zero_node(lay, node):
        stacked = node[lay.table_leaves[0]].ndim == 3
        for key in lay.poison_leaves:
            pool = node[key]
            row_t = torch.as_tensor(table_row, dtype=torch.int64,
                                    device=pool.device).reshape(-1)
            ps = pool.shape[2] if stacked else pool.shape[1]
            logical = torch.arange(row_t.shape[0] * ps, device=pool.device)
            live = (logical >= start) & (logical < stop)
            page = torch.where(live, row_t[logical // ps],
                               kvc.GARBAGE_PAGE)
            row = logical % ps
            if stacked:
                pool[:, page, row] = 0
            else:
                pool[page, row] = 0
        return node

    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.paged and lay.poison_leaves:
                return zero_node(lay, node)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def reset_state_slots(cache_tree, slots):
    """Zero the given batch slots of every recurrent node of a (possibly
    layer-stacked, possibly hybrid) cache tree, in place: on admit (a fresh
    request must not see the evicted tenant's state) and before the decode
    step after an evict or preempt (idle lanes decode against zeroed
    state). Other nodes pass through."""
    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.recurrent:
                return lay.slot_reset(node, slots)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def slice_state_slot(cache_tree, slot: int):
    """Batch-1 copy of one slot's recurrent state, the admission prefill's
    tree; every other node (paged pools, tables) passes through by
    reference. On an attention-only tree this is the identity walk."""
    def walk(node):
        if isinstance(node, dict):
            lay = match_layout(node)
            if lay is not None and lay.recurrent:
                return lay.slot_snapshot(node, slot)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache_tree)


def merge_state_slot(full_tree, part_tree, slot: int):
    """Fold an admission prefill's batch-1 tree back into the full tree:
    recurrent nodes write the part's row into the full tree's leaves in
    place; every other node takes the part's value (the pools the prefill
    wrote in place, under the slot's block tables)."""
    def walk(full, part):
        if isinstance(full, dict) and isinstance(part, dict):
            lay = match_layout(full)
            if lay is not None and lay.recurrent:
                return lay.slot_restore(full, part, slot)
            return {k: walk(full[k], part[k]) for k in full}
        return part

    return walk(full_tree, part_tree)

