"""Hybrid-precision KV tiering: int8 cold pages + a full-precision hot
window over the paged pool (port of ``repro/runtime/kv_quant.py``).

The last ``hot_window`` pages of every request stay in the fp pools (the
"SRAM" tier: every write lands there); pages that age out of the window are
quantized once, per page and per KV head, into int8 pools with f32 absmax
scales (the "ReRAM" tier) and decode reads them from there. Leaf schema
and routing live in ``runtime/layouts.py`` (:class:`PagedQ8Layout`).

The MLA latent tier (:class:`PagedMLAQ8Layout`) quantizes each aged-out
page of the ``cl`` latent pool with ONE absmax scale over the whole
(page_size, r + d_rope) page, *before* the W_uk/W_uv expansion: the
rounding error reaches every head's keys and values at once (its own
error model, held against the tier-mixing absorbed oracle,
:func:`dequant_gather_mla`).

Hotness rule (shared by kernel K6, :func:`dequant_gather` and
:class:`KVTierTracker`): block ``s`` of a request at ``pos`` is HOT iff
``s > pos // page_size - hw``. The block holding ``pos`` is always hot;
``hw >= W`` never reads the int8 tier.

Scale numerics: the reference writes ``max(absmax, 1e-8) / 127``, but its
serve path runs the quantize op under ``jit``, where XLA compiles the
division by the constant into a multiply by ``f32(1/127)``; the port
computes that compiled form (as kernel K3 does) so codes and scales are
bit-equal to the reference's served state. The codes themselves are
``clip(round_half_even(x / scale), ±127)`` with a true division.

The pools are updated IN PLACE (the reference returns new arrays).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.runtime import kv_cache as kvc

INT8_MAX = 127.0
# f32(1/127): the factor XLA's compiled division by 127 multiplies by
INV_INT8_MAX = float(torch.tensor(1.0) / torch.tensor(INT8_MAX))


# ----------------------------------------------------------------------------
# device-side ops
# ----------------------------------------------------------------------------
def quantize_pages_layer(c: dict, pages) -> dict:
    """Quantize physical pages ``pages`` of one quantized GQA cache dict
    (single layer, or layer-stacked with a leading (L,) dim on every leaf)
    from the fp pools into the int8 pools and per-page, per-head scales.
    Idempotent; padding ``pages`` with the garbage page 0 is harmless (page
    0 is always masked on read). In place; returns ``c``."""
    stacked = c['ks'].ndim == 3
    pool_dev = c['k'].device
    idx = torch.as_tensor(pages, dtype=torch.int64,
                          device=pool_dev).reshape(-1)
    for pool, qpool, sc in (('k', 'kq', 'ks'), ('v', 'vq', 'vs')):
        tiles = (c[pool][:, idx] if stacked else c[pool][idx]).to(
            torch.float32)                       # ([L,] N, ps, Hkv, dh)
        amax = tiles.abs().amax(dim=(-3, -1), keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) * INV_INT8_MAX
        q8 = torch.clamp(torch.round(tiles / scale), -INT8_MAX,
                         INT8_MAX).to(torch.int8)
        if stacked:
            c[qpool][:, idx] = q8
            c[sc][:, idx] = scale[..., 0, :, 0]
        else:
            c[qpool][idx] = q8
            c[sc][idx] = scale[..., 0, :, 0]
    return c


def quantize_latent_pages_layer(c: dict, pages) -> dict:
    """Quantize physical pages ``pages`` of one quantized MLA latent cache
    dict (single layer, or layer-stacked) from the fp ``cl`` pool into the
    int8 ``clq`` pool with one absmax scale per page (``cs`` (P, 1)); the
    scale in the compiled form, as :func:`quantize_pages_layer`. Same
    idempotence and garbage-page padding contract. In place; returns
    ``c``."""
    stacked = c['cs'].ndim == 3
    idx = torch.as_tensor(pages, dtype=torch.int64,
                          device=c['cl'].device).reshape(-1)
    tiles = (c['cl'][:, idx] if stacked else c['cl'][idx]).to(
        torch.float32)                           # ([L,] N, ps, r + d_rope)
    amax = tiles.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * INV_INT8_MAX
    q8 = torch.clamp(torch.round(tiles / scale), -INT8_MAX,
                     INT8_MAX).to(torch.int8)
    if stacked:
        c['clq'][:, idx] = q8
        c['cs'][:, idx] = scale[..., 0, :]
    else:
        c['clq'][idx] = q8
        c['cs'][idx] = scale[..., 0, :]
    return c


def quantize_tree_pages(cache_tree, pages):
    """Quantize ``pages`` in every quantized layer dict of a (possibly
    layer-stacked) cache tree. Page indices are physical, so one vector
    covers every layer. Kept here as the public name the scheduler calls;
    the layout registry owns the walk."""
    from repro_torch.runtime import layouts
    return layouts.quantize_tree_pages(cache_tree, pages)


def _hot_mask(c: dict, pos: torch.Tensor, pool_key: str = 'k'
              ) -> torch.Tensor:
    """(B, W * page_size) bool hot mask of one quantized cache dict at
    per-request ``pos`` — THE hotness rule, as kernels K6 and K10
    evaluate it. ``pool_key`` names the fp pool that gives the page
    size."""
    bt = c['bt']
    ps = c[pool_key].shape[1]
    w = bt.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64,
                          device=bt.device).reshape(-1)
    last = pos // ps
    hot_blk = (torch.arange(w, device=bt.device)[None, :]
               > (last[:, None] - c['hw'][0].to(torch.int64)))   # (B, W)
    return hot_blk.repeat_interleave(ps, dim=1)


def dequant_gather(c: dict, pos):
    """Densify one quantized GQA cache dict into contiguous
    (B, W * ps, Hkv, dh) K/V views in the fp pool's dtype, mixing tiers
    per the hotness rule (the einsum-oracle path of the tier). The cold
    dequant ``int8 * scale`` is rounded through the pool dtype, as kernel
    K6 rounds it."""
    hot = _hot_mask(c, pos)[:, :, None, None]
    bt = c['bt'].to(torch.int64)

    def densify(pool, qpool, sc):
        fp = kvc.gather_pages(pool, bt)
        q_pages = c[qpool][bt].to(torch.float32)        # (B, W, ps, Hkv, dh)
        scales = c[sc][bt][:, :, None, :, None]          # (B, W, 1, Hkv, 1)
        cold = (q_pages * scales).reshape(fp.shape).to(pool.dtype)
        return torch.where(hot, fp, cold)

    return densify(c['k'], 'kq', 'ks'), densify(c['v'], 'vq', 'vs')


def dequant_gather_mla(c: dict, pos) -> torch.Tensor:
    """Densify one quantized MLA latent cache dict into the contiguous
    (B, W * ps, r + d_rope) latent view in the fp pool's dtype, mixing
    tiers per the hotness rule (the absorbed-einsum-oracle path of the
    latent tier; the caller splits ckv/krope at ``r``). The cold dequant
    is rounded through the pool dtype, as kernel K10 rounds it."""
    hot = _hot_mask(c, pos, pool_key='cl')[:, :, None]
    bt = c['bt'].to(torch.int64)
    fp = kvc.gather_pages(c['cl'], bt)
    q_pages = c['clq'][bt].to(torch.float32)         # (B, W, ps, dk)
    scales = c['cs'][bt][:, :, None, :]              # (B, W, 1, 1)
    cold = (q_pages * scales).reshape(fp.shape).to(c['cl'].dtype)
    return torch.where(hot, fp, cold)


# ----------------------------------------------------------------------------
# host-side tier bookkeeping
# ----------------------------------------------------------------------------
def cold_block_count(pos: int, page_size: int, hot_window: int) -> int:
    """Leading blocks outside the hot window for a request about to write
    at ``pos`` — the host-side form of the hotness rule."""
    return max(0, pos // page_size + 1 - hot_window)


def cold_page_list(tables, pos, page_size: int, hot_window: int) -> List[int]:
    """Physical pages outside each request's hot window, from block-table
    rows and per-request positions (one-shot tier construction)."""
    tables = np.asarray(tables)
    pos = np.asarray(pos).reshape(-1)
    pages: List[int] = []
    for b in range(tables.shape[0]):
        cold = cold_block_count(int(pos[b]), page_size, hot_window)
        pages.extend(int(p) for p in tables[b, :cold])
    return pages


class KVTierTracker:
    """Per slot, how many leading blocks have aged out of the hot window
    and been quantized. The scheduler calls :meth:`aged_out` each step and
    :meth:`reset` on release (the pages' next owner re-quantizes them)."""

    def __init__(self, hot_window: int, page_size: int):
        assert hot_window >= 1, \
            'hot_window must be >= 1: the page being written is always hot'
        self.hot_window = hot_window
        self.page_size = page_size
        self._upto: dict = {}            # slot -> blocks already quantized

    def aged_out(self, slot: int, pos: int, table_row) -> List[int]:
        """Physical pages of ``slot`` that just crossed the hot-window
        boundary given the position about to be written. Call AFTER the
        slot's table is grown for ``pos`` and BEFORE the decode step."""
        cold = cold_block_count(pos, self.page_size, self.hot_window)
        done = self._upto.get(slot, 0)
        if cold <= done:
            return []
        self._upto[slot] = cold
        return [int(p) for p in table_row[done:cold]]

    def reset(self, slot: int) -> None:
        self._upto.pop(slot, None)

    def cold_blocks(self, slot: int) -> int:
        """Blocks of ``slot`` already in the int8 tier: the measured
        residency the energy meter prices (it lags the rule's steady state
        after an admission, and a dropped quantize chunk still counts)."""
        return self._upto.get(slot, 0)

    def residency(self) -> dict:
        """``slot -> cold block count`` for every tracked slot."""
        return dict(self._upto)
