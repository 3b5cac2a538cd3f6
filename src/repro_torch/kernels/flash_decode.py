"""Flash attention for batched serving: kernels K1, K5, K6 (GQA over a
paged pool), K7 (GQA over a contiguous cache) and K8, K9, K10 (absorbed
MLA over a latent pool).

Ports of the entry points of ``repro/kernels/flash_decode.py``.
The reference runs every entry point through one online-softmax body
(``_softmax_tile``) and one grid harness (``_flash_core``) and differs per
layout only in a tile loader and a row mask; the plain versions here do
the same (:func:`_softmax_plain`). On the card two bodies in
``csrc/flash_decode.cu`` serve them, each launch running two device
kernels: the key split (K1, K5, K6, K7: the key axis cut over blocks by a
plan that depends on the shapes only, the splits merged by a second
kernel) over a row loader per layout, K5 with a chunk's per-row
positions; and the latent key split (K8, K9, K10: the same cut of an
absorbed-MLA latent pool, both products on tensor cores, merged by the key
split's combine), K9 with a chunk's per-row positions:

* **K1** ``flash_decode_gqa_paged`` with ``chunk=1`` (through
  ``flash_decode_paged``): one query token per request attends its paged
  KV cache with per-request ``pos`` and sliding ``window`` and a
  per-request block table. The key split reads each key row through the
  block table (:func:`paged_split_plan`: tiles of whole pages).
* **K5** the same function with ``chunk > 1`` (through
  ``flash_chunk_paged``): C query rows per request at positions
  ``offset .. offset + C - 1`` with a per-row causal/window mask, over
  fetch-union ``pos``/``window`` scalars (:func:`_chunk_scalars`). It runs
  K1's key split with 2 query rows a block (:func:`chunk_split_plan`),
  each row masking its own keys.
* **K6** ``flash_decode_gqa_paged_q8`` (through ``flash_decode_paged_q8``):
  K1 over the hybrid int8 tier; each page is read from one tier only, hot
  pages from the fp pools, cold pages from the int8 pools times a per-page,
  per-head scale, rounded through the pool dtype. It runs K1's key split
  and plan, so with a hot window covering the table it equals K1 bit for
  bit.
* **K7** ``flash_decode_gqa`` (through ``flash_decode``): K1's function
  over a contiguous (B, S_max, Hkv, dh) cache, the static ``serve()``
  path's. Unlike the reference it pads nothing: keys at or past S_max are
  masked. The key split's plan is :func:`contig_split_plan`.
  ``impl='streamed'`` (the reference's legacy baseline) walks every key
  tile instead of the live ones, with bit-equal output.
* **K8** ``flash_decode_mla_paged`` with ``chunk=1`` (through
  ``flash_decode_paged_mla``): absorbed MLA decode over a latent pool
  (P, page_size, r + d_rope). MLA is GQA with one KV head and all H query
  heads in its group; each latent tile is read once and used twice: all
  r + d_rope columns as the keys (against the absorbed+rope query), the
  first r columns as the values. Returns the f32 latent output; the caller
  applies ``W_uv``. The latent key split's plan is
  :func:`latent_split_plan`; its tensor-core products take every f32
  operand as three bf16 parts.
* **K9** the same function with ``chunk > 1`` (through
  ``flash_chunk_paged_mla``): C·H query rows, row i at position
  ``offset + i // H``, with K5's fetch-union scalars. It runs K8's kernel
  with a chunk's rows, planned by :func:`latent_split_plan` for the C·H
  rows (32 a block, so one position a block at H=128), each row masking
  its own keys.
* **K10** ``flash_decode_mla_paged_q8`` (through
  ``flash_decode_paged_mla_q8``): K8 over the int8 latent tier, cold pages
  ``int8 * scale[page]`` (one scale per page) rounded through the pool
  dtype. It runs K8's kernel and plan, so with a hot window covering the
  table it equals K8 bit for bit.

The plain versions are tile-by-tile loops (a page, or K7's 32 keys) that
mirror ``_softmax_tile``, dead-step semantics included. The wrappers take
them only for CPU tensors; for CUDA tensors they launch the kernel or
raise.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build, meta

NEG_INF = float('-inf')


def _softmax_plain(q: torch.Tensor, load_kv, pos: torch.Tensor,
                   window: torch.Tensor, n_tiles: int, tile: int, *,
                   scale: float, offset=None, chunk: int = 1, dv=None,
                   prefetch: bool = True) -> torch.Tensor:
    """The one online-softmax body of the plain versions. q (B, Hkv, R,
    dh); ``load_kv(s)`` -> f32 (B, n, Hkv, dh) K and (B, n, Hkv, dv) V
    tiles of the keys [s * tile, s * tile + n), n <= ``tile`` (``dv``
    defaults to dh). Returns f32 (B, Hkv, R, dv). Row r sits at ``pos``
    (``chunk == 1``) or at ``offset + r // (R // chunk)`` with the row
    window ``window - (chunk - 1)``. One step per tile, all requests at
    once; a request whose tile ``s`` is outside its live range keeps its
    state, as the reference's dead grid steps do (``prefetch=False``: every
    tile is computed, masked, which leaves the state bit-unchanged)."""
    b, hkv, rows, dh = q.shape
    dev = q.device
    qf = q.to(torch.float32)
    pos = pos.to(torch.int64)
    win = window.to(torch.int64)
    acc = torch.zeros((b, hkv, rows, dh if dv is None else dv),
                      dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, rows, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, rows, 1), dtype=torch.float32, device=dev)
    first = torch.clamp_min(pos - win + 1, 0) // tile
    last = torch.clamp_min(pos, 0) // tile
    if chunk == 1:
        qp = pos[:, None]                                        # (B, 1)
        row_win = win[:, None]
    else:
        group = rows // chunk
        qp = (offset.to(torch.int64)[:, None]
              + torch.arange(rows, device=dev)[None, :] // group)  # (B, R)
        row_win = (win - (chunk - 1))[:, None]
    for s in range(n_tiles):
        live = (s >= first) & (s <= last)                        # (B,)
        if not prefetch:
            live = torch.ones_like(live)
        if not bool(live.any()):
            continue
        kt, vt = load_kv(s)                             # (B, n, Hkv, dh)
        kpos = (s * tile + torch.arange(kt.shape[1], device=dev))[None, None]
        valid = ((kpos <= qp[:, :, None])
                 & (kpos > qp[:, :, None] - row_win[:, :, None]))
        valid = valid[:, None]                          # (B, 1, R|1, n)
        logits = torch.einsum('bhgd,bshd->bhgs', qf, kt) * scale
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        # all-masked guards: exp(-inf - -inf) must contribute 0, not 1
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.where(valid, torch.exp(logits - m_new), 0.0)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum('bhgs,bshd->bhgd', p, vt)
        lv = live[:, None, None, None]
        acc = torch.where(lv, acc_new, acc)
        l = torch.where(lv, l_new, l)
        m = torch.where(lv, m_new, m)
    # the one output conversion: normalize once, after the full reduction
    return acc / torch.clamp_min(l, 1e-30)


def _paged_softmax_plain(q: torch.Tensor, load_kv, pos: torch.Tensor,
                         window: torch.Tensor, block_tables: torch.Tensor,
                         page_size: int, **kw) -> torch.Tensor:
    """:func:`_softmax_plain` over a paged pool, one step per logical
    block: ``load_kv(s, page)`` reads block ``s`` from its physical pages
    ``page`` (B,)."""
    return _softmax_plain(
        q, lambda s: load_kv(s, block_tables[:, s].to(torch.int64)), pos,
        window, block_tables.shape[1], page_size, **kw)


def _fp_loader(k_pages, v_pages):
    return lambda s, page: (k_pages[page].to(torch.float32),
                            v_pages[page].to(torch.float32))


def flash_decode_gqa_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, pos: torch.Tensor,
                                 window: torch.Tensor,
                                 block_tables: torch.Tensor, offset=None, *,
                                 scale: float, chunk: int = 1) -> torch.Tensor:
    """q (B, Hkv, G, dh); k/v_pages (P, page_size, Hkv, dh); pos, window
    (B,) int; block_tables (B, W) int. Returns f32 (B, Hkv, G, dh).

    ``chunk > 1`` is the chunked-prefill shape (K5): G widens to chunk * G
    (row i = query head i % G at position ``offset + i // G``), ``offset``
    (B,) carries each chunk's start, and ``pos``/``window`` are the
    fetch-union scalars of :func:`_chunk_scalars`."""
    if (offset is None) != (chunk == 1) or q.shape[2] % chunk:
        raise ValueError(f'chunk={chunk} needs an offset and G % chunk == 0 '
                         f'(G={q.shape[2]}, offset={offset is not None})')
    return _paged_softmax_plain(q, _fp_loader(k_pages, v_pages), pos, window,
                                block_tables, k_pages.shape[1], scale=scale,
                                offset=offset, chunk=chunk)


def flash_decode_gqa_paged_q8_plain(q, k_pages, v_pages, kq_pages, vq_pages,
                                    k_scales, v_scales, pos, window,
                                    block_tables, hot_window, *,
                                    scale: float) -> torch.Tensor:
    """K1 over the hybrid tier: kq/vq (P, ps, Hkv, dh) int8, k/v_scales
    (P, Hkv) f32, hot_window (1,) int. Block ``s`` is hot iff
    ``s > max(pos, 0) // ps - hot_window``; a hot block reads the fp pools,
    a cold one ``int8 * scale`` rounded through the pool dtype (selected,
    so an unread tier never reaches the result). Returns f32."""
    ps = k_pages.shape[1]
    last = torch.clamp_min(pos.to(torch.int64), 0) // ps
    hw = hot_window.reshape(-1)[0].to(torch.int64)

    def load(s, page):
        hot = (s > last - hw)[:, None, None, None]
        out = []
        for fp, q8, sc in ((k_pages, kq_pages, k_scales),
                           (v_pages, vq_pages, v_scales)):
            cold = (q8[page].to(torch.float32)
                    * sc[page].to(torch.float32)[:, None, :, None])
            cold = cold.to(fp.dtype).to(torch.float32)
            out.append(torch.where(hot, fp[page].to(torch.float32), cold))
        return out[0], out[1]

    return _paged_softmax_plain(q, load, pos, window, block_tables, ps,
                                scale=scale)


def _latent_loader(c_pages, r: int):
    """Fetch once, use twice: the (B, ps, 1, r + d_rope) latent tile as
    the keys, its first ``r`` columns as the values."""
    def load(s, page):
        lat = c_pages[page].to(torch.float32)[:, :, None, :]
        return lat, lat[..., :r]
    return load


def flash_decode_mla_paged_plain(q: torch.Tensor, c_pages: torch.Tensor,
                                 pos: torch.Tensor, window: torch.Tensor,
                                 block_tables: torch.Tensor, offset=None, *,
                                 scale: float, r: int,
                                 chunk: int = 1) -> torch.Tensor:
    """q (B, 1, R, r + d_rope) f32, the absorbed+rope query (R = H, or
    C * H with row i = head i % H at ``offset + i // H`` when
    ``chunk > 1``); c_pages (P, page_size, r + d_rope); pos, window (B,)
    int (fetch-union scalars for a chunk); block_tables (B, W) int.
    Returns the f32 latent output (B, 1, R, r), before ``W_uv``."""
    if (offset is None) != (chunk == 1) or q.shape[2] % chunk:
        raise ValueError(f'chunk={chunk} needs an offset and R % chunk == 0 '
                         f'(R={q.shape[2]}, offset={offset is not None})')
    return _paged_softmax_plain(q, _latent_loader(c_pages, r), pos, window,
                                block_tables, c_pages.shape[1], scale=scale,
                                offset=offset, chunk=chunk, dv=r)


def flash_decode_mla_paged_q8_plain(q, c_pages, cq_pages, c_scales, pos,
                                    window, block_tables, hot_window, *,
                                    scale: float, r: int) -> torch.Tensor:
    """K8 over the int8 latent tier: cq_pages (P, ps, r + d_rope) int8,
    c_scales (P, 1) f32, hot_window (1,) int. Block ``s`` is hot iff
    ``s > max(pos, 0) // ps - hot_window``; a cold block reads
    ``int8 * scale[page]`` rounded through the pool dtype (selected, so an
    unread tier never reaches the result). Returns f32 (B, 1, H, r)."""
    ps = c_pages.shape[1]
    last = torch.clamp_min(pos.to(torch.int64), 0) // ps
    hw = hot_window.reshape(-1)[0].to(torch.int64)

    def load(s, page):
        hot = (s > last - hw)[:, None, None, None]
        cold = (cq_pages[page].to(torch.float32)
                * c_scales[page].to(torch.float32)[:, :, None])
        cold = cold.to(c_pages.dtype).to(torch.float32)[:, :, None, :]
        lat = torch.where(hot, c_pages[page].to(torch.float32)[:, :, None, :],
                          cold)
        return lat, lat[..., :r]

    return _paged_softmax_plain(q, load, pos, window, block_tables, ps,
                                scale=scale, dv=r)


#: keys per step of K7's plain version
CONTIG_TILE = 32

#: the key split (``csrc/flash_decode.cu``, ``key_split_kernel``) of K7,
#: K1 and K6: warps a block, keys a lane group takes per online-softmax
#: update, the least tile, and the blocks a launch aims at (16 resident on
#: each of 132 SMs)
CONTIG_WARPS = 4
CONTIG_STEP_KEYS = 4
CONTIG_MIN_TILE = 64
CONTIG_TARGET_BLOCKS = 16 * 132
#: the most pages a split of K1 or K6 stages in shared memory (their ids
#: and, for K6, their scales)
PAGED_SPLIT_PAGES = 256


#: the widest key row the key split reads: 32 lanes of one 16-byte piece
#: in bf16, of two in f32
SPLIT_MAX_DH = 256


def _split_plan(name: str, b: int, s: int, hkv: int, g: int, dh: int,
                itemsize: int, page_size: int = 1, max_pages: int = 0,
                rows: int = 0) -> dict:
    """The key split of ``s`` keys a request for ``g`` query rows a KV
    head, ``rows`` of them a block (0: 1 if g == 1 else 2), tiles a
    multiple of ``page_size`` keys and, if ``max_pages``, at most that
    many pages a split. A row of more than 32 16-byte pieces (f32, dh >
    128) gives each of the 32 lanes ``pieces`` = 2 of them; the kernel
    takes ceil(dh / (lpk * 16 / itemsize)) pieces a lane, the same
    number."""
    vec = 16 // itemsize
    n_pieces = -(-dh // vec)
    if dh > SPLIT_MAX_DH:
        raise ValueError(f'{name}: dh={dh} exceeds the kernel limit of '
                         f'{SPLIT_MAX_DH} for {itemsize}-byte cache '
                         f'elements')
    pieces = 1 if n_pieces <= 32 else 2
    lpk = 1 << (-(-n_pieces // pieces) - 1).bit_length()
    span = CONTIG_WARPS * (32 // lpk) * CONTIG_STEP_KEYS
    tile = math.lcm(max(CONTIG_MIN_TILE, span), page_size)
    n_tiles = -(-s // tile)
    rows = rows or (1 if g == 1 else 2)
    blocks = b * hkv * -(-g // rows)
    want = max(1, -(-CONTIG_TARGET_BLOCKS // max(blocks, 1)))
    per = -(-n_tiles // want)
    if max_pages:
        per = min(per, max(1, max_pages * page_size // tile))
    return dict(lpk=lpk, pieces=pieces, tile=tile, tiles_per_split=per,
                n_splits=-(-n_tiles // per), rows=rows)


def contig_split_plan(b: int, s: int, hkv: int, g: int, dh: int,
                      itemsize: int) -> dict:
    """How K7 cuts the key axis of a (B, S, Hkv, dh) cache of ``itemsize``
    bytes an element: ``lpk`` lanes (``pieces`` 16 bytes each) read one
    key row, absolute tiles of ``tile`` keys, ``tiles_per_split`` tiles a
    block, ``n_splits`` blocks a (request, KV head) and row group of
    ``rows`` query rows. It depends on the shapes only, never on positions, so the
    prefetch and streamed walks cut the keys identically."""
    return _split_plan('flash_decode_gqa', b, s, hkv, g, dh, itemsize)


def paged_split_plan(b: int, w: int, page_size: int, hkv: int, g: int,
                     dh: int, itemsize: int) -> dict:
    """K1's and K6's cut of the W * page_size keys a (B, W) block table
    reaches in (P, page_size, Hkv, dh) pools: :func:`contig_split_plan`'s,
    with tiles of whole pages and at most PAGED_SPLIT_PAGES pages a split.
    It depends on the shapes only (no positions, no table), so a step
    reads nothing back to the host."""
    return _split_plan('flash_decode_gqa_paged', b, w * page_size, hkv, g,
                       dh, itemsize, page_size, PAGED_SPLIT_PAGES)


#: K5's query rows a block (``key_split_kernel``'s one chunk instance): of
#: 2, 4 and 8 timed on the H100 (PERF.md §6), 2 was fastest at every bf16
#: row, where 8 rows take all 255 registers and a quarter of the
#: occupancy, and kept f32 pools within 1.25x of bf16 at the serving
#: chunks
CHUNK_ROWS = 2


def chunk_split_plan(b: int, w: int, page_size: int, hkv: int, c: int,
                     g: int, dh: int, itemsize: int) -> dict:
    """K5's cut: :func:`paged_split_plan`'s over the W * page_size keys,
    for a chunk's C * G query rows a KV head (row r at offset + r // G),
    CHUNK_ROWS of them a block, so one read of a key row serves that many
    query rows. Shapes only, never positions."""
    if c < 2 or g < 1 or itemsize not in (2, 4):
        raise ValueError(f'flash_chunk_paged: a chunk plan takes C >= 2 '
                         f'query positions, G >= 1 and bf16 or f32 pools '
                         f'(C={c}, G={g}, itemsize={itemsize})')
    return _split_plan('flash_chunk_paged', b, w * page_size, hkv, c * g,
                       dh, itemsize, page_size, PAGED_SPLIT_PAGES, CHUNK_ROWS)


#: the latent split (``csrc/flash_decode.cu``, ``latent_split_kernel``) of
#: K8, K9 and K10: query rows a block, keys a pipeline step, the card's
#: SMs, the most pages a split stages, and the widths its registers hold (a
#: warp's quarter of the DK query columns, 9 k-steps of 16; of the DV
#: value columns, 16 tiles of 8)
LATENT_ROWS = 32
LATENT_STEP = 32
LATENT_SMS = 132
LATENT_SPLIT_PAGES = 256
LATENT_MAX_DK = 576
LATENT_MAX_DV = 512


def latent_split_plan(b: int, w: int, page_size: int, h: int, dk: int,
                      dv: int, itemsize: int) -> dict:
    """How K8 and K10 cut the W * page_size keys a (B, W) block table
    reaches in a (P, page_size, dk) latent pool of ``itemsize`` bytes an
    element, for ``h`` query rows of ``dv`` value columns: ``rows`` query
    rows a block, absolute tiles of ``tile`` keys (whole pages and whole
    32-key steps), ``tiles_per_split`` tiles a block and ``n_splits`` blocks
    a (request, row group). Shapes only: no position and no table is read,
    so a step reads nothing back to the host (and the cut is cached). K9
    takes the same cut with ``h`` = a chunk's C·H rows: at H=128, W=20
    pages of 8, C=8 gives 32 row groups of 5 splits of one tile (160
    blocks), C=32 128 row groups of one split (one wave of 128 blocks).

    It trades three costs:

    * **The latent's re-reads from L2.** Every row group stages the same
      latent rows, H / rows times a slot. A 32-row block (8 warps, ~240
      registers a thread: one block an SM) reads each row 4 times at
      H=128; 16-row blocks (two an SM) read it 8 times and were slower on
      the H100 at every shape tried while the kernel was written, so rows
      is 32.
    * **Filling the card.** Splits exist to give the SMs work: the plan
      uses at most enough of them to put a block on each of the 132 SMs
      (one block an SM), and among those the count whose launch ends
      soonest, waves of 132 blocks times the tiles a block walks; of two
      that end together, the one that gives every SM a block. At the
      serving row (B=8, H=128, W=20 pages of 8: 5 tiles a slot) 5 splits of
      1 tile (160 blocks, two waves) and 3 splits of 2 tiles (96 blocks,
      one wave) both take 2, and the 5 are taken; at W=512 (128 tiles) 4
      splits of 32 tiles end in one wave of 128 blocks, where 5 would take
      two waves of 26.
    * **The partials.** Each split writes, and the combine reads back,
      B * splits * H * (dv + 2) f32 values: at H=128, dv=512 a split costs
      256 KB, the latent of ~230 bf16 keys, so among plans otherwise equal
      the one with fewer splits wins, and a batch that fills the SMs alone
      is not split at all.
    """
    if (dk % 8 or not 0 < dv < dk or dv % 8 or dk > LATENT_MAX_DK
            or dv > LATENT_MAX_DV or itemsize not in (2, 4) or page_size < 1
            or w < 1 or b < 1 or h < 1):
        raise ValueError(
            f'flash_decode_mla_paged: the latent split takes dk <= '
            f'{LATENT_MAX_DK} and 0 < dv < dk, both multiples of 8, dv <= '
            f'{LATENT_MAX_DV}, bf16 or f32 pools (dk={dk}, dv={dv}, '
            f'itemsize={itemsize}, page_size={page_size}, W={w})')
    tile, tps, n_splits = _latent_cut(b, w, page_size, h, LATENT_SMS)
    return dict(rows=LATENT_ROWS, tile=tile, tiles_per_split=tps,
                n_splits=n_splits)


@functools.lru_cache(maxsize=256)
def _latent_cut(b: int, w: int, page_size: int, h: int, sms: int) -> tuple:
    """(tile, tiles_per_split, n_splits) of :func:`latent_split_plan`."""
    tile = math.lcm(LATENT_STEP, page_size)
    n_tiles = -(-w * page_size // tile)
    pairs = b * -(-h // LATENT_ROWS)
    max_tps = max(1, LATENT_SPLIT_PAGES * page_size // tile)
    best = None
    for tps in range(min(n_tiles, max_tps), 0, -1):
        n_splits = -(-n_tiles // tps)
        if n_splits > max(1, -(-sms // pairs)) and best is not None:
            break                         # more splits than the SMs need
        waves = -(-pairs * n_splits // sms)
        key = (waves * tps, pairs * n_splits < sms, n_splits)
        if best is None or key < best[0]:
            best = (key, n_splits, tps)
    _, n_splits, tps = best
    return tile, tps, n_splits


def flash_decode_gqa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, window: torch.Tensor, *,
                           scale: float, prefetch: bool = True
                           ) -> torch.Tensor:
    """q (B, Hkv, G, dh); k/v (B, S, Hkv, dh); pos, window (B,) int: row b
    attends ``pos[b] - window[b] < kpos <= pos[b]``, keys past S masked.
    Returns f32 (B, Hkv, G, dh). ``prefetch=False`` is the streamed
    baseline: every tile computed, masked, with bit-equal output."""
    s_max = k.shape[1]

    def load(s):
        sl = slice(s * CONTIG_TILE, min((s + 1) * CONTIG_TILE, s_max))
        return k[:, sl].to(torch.float32), v[:, sl].to(torch.float32)

    return _softmax_plain(q, load, pos, window, -(-s_max // CONTIG_TILE),
                          CONTIG_TILE, scale=scale, prefetch=prefetch)


_FP = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)


def _check_paged(name, q, k_pages, v_pages, pos, window, block_tables):
    """Shape and dtype checks shared by the kernel wrappers; returns
    (b, hkv, rows, dh, page_size, w)."""
    b, hkv, rows, dh = q.shape
    n_pages, page_size = k_pages.shape[:2]
    w = block_tables.shape[1]
    if (tuple(k_pages.shape) != (n_pages, page_size, hkv, dh)
            or v_pages.shape != k_pages.shape
            or v_pages.dtype != k_pages.dtype
            or tuple(pos.shape) != (b,) or tuple(window.shape) != (b,)
            or tuple(block_tables.shape) != (b, w)):
        raise ValueError(
            f'{name}: q {tuple(q.shape)}, pools {tuple(k_pages.shape)}/'
            f'{tuple(v_pages.shape)} ({k_pages.dtype}/{v_pages.dtype}), pos '
            f'{tuple(pos.shape)}, window {tuple(window.shape)}, tables '
            f'{tuple(block_tables.shape)}')
    return b, hkv, rows, dh, page_size, w


_K1_ARGS = [build.P] * 10 + [build.I] * 11 + [build.F, build.I, build.P]
_K5_ARGS = [build.P] * 11 + [build.I] * 12 + [build.F, build.I, build.P]
_K6_ARGS = [build.P] * 15 + [build.I] * 11 + [build.F, build.I, build.P]
_K7_ARGS = [build.P] * 9 + [build.I] * 10 + [build.F, build.I, build.I,
                                              build.P]
_K8_ARGS = [build.P] * 9 + [build.I] * 10 + [build.F, build.I, build.P]
_K9_ARGS = [build.P] * 10 + [build.I] * 11 + [build.F, build.I, build.P]
_K10_ARGS = [build.P] * 12 + [build.I] * 10 + [build.F, build.I,
                                               build.P]


def _split_scratch(b: int, hkv: int, g: int, dh: int, plan: dict, device):
    """The key splits' partials (running max, sum, unnormalised
    accumulator) and the f32 (B, Hkv, G, dh) output of a split launch."""
    part_m = torch.empty((b * hkv, plan['n_splits'], g), dtype=torch.float32,
                         device=device)
    part_acc = torch.empty((b * hkv, plan['n_splits'], g, dh),
                           dtype=torch.float32, device=device)
    out = torch.empty((b, hkv, g, dh), dtype=torch.float32, device=device)
    return (part_m, torch.empty_like(part_m), part_acc), out


def _plan_args(plan: dict):
    return (plan['rows'], plan['lpk'], plan['tile'], plan['tiles_per_split'],
            plan['n_splits'])


def _latent_plan_args(plan: dict):
    return (plan['rows'], plan['tile'], plan['tiles_per_split'],
            plan['n_splits'])


def flash_decode_gqa_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pos: torch.Tensor,
                           window: torch.Tensor, block_tables: torch.Tensor,
                           offset=None, *, scale: float,
                           chunk: int = 1, ways: int = 1) -> torch.Tensor:
    """Same contract as :func:`flash_decode_gqa_paged_plain`: kernel K1
    (``chunk == 1``) or K5 (``chunk > 1``). On CUDA the query must be f32,
    the pools bf16 or f32 (one dtype), and pos, window, offset and block
    tables int32. Both run two device kernels, the key splits of
    :func:`paged_split_plan` or :func:`chunk_split_plan` and their
    combine, with the splits' partials in scratch allocated here. Rows of
    a chunk past its limit (padding) stay finite but may differ from the
    plain version's: the kernel reads no key past the fetch-union
    position. ``ways``: the tensor-parallel degree the KV heads were split
    over; the plan is made for all ``Hkv * ways`` heads, so each (request,
    head)'s keys are cut as on one device and the rank's heads come out
    bit-equal to its slice of the whole."""
    tensors = (q, k_pages, v_pages, pos, window, block_tables) + (
        () if offset is None else (offset,))
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_decode_gqa_paged_plain(q, k_pages, v_pages, pos, window,
                                            block_tables, offset,
                                            scale=scale, chunk=chunk)
    name = 'flash_decode_gqa_paged'
    b, hkv, rows, dh, page_size, w = _check_paged(name, q, k_pages, v_pages,
                                                  pos, window, block_tables)
    if (offset is None) != (chunk == 1) or rows % chunk \
            or (offset is not None and tuple(offset.shape) != (b,)):
        raise ValueError(f'{name}: chunk={chunk} needs a (B,) offset and '
                         f'rows % chunk == 0 (rows={rows})')
    build.require_cuda(name, *tensors,
                       dtypes=[(torch.float32,), _FP, _FP, _I32, _I32, _I32,
                               _I32])
    is_bf16 = int(k_pages.dtype == torch.bfloat16)
    if chunk == 1:
        plan = paged_split_plan(b, w, page_size, hkv * ways, rows, dh,
                                k_pages.element_size())
        part, out = _split_scratch(b, hkv, rows, dh, plan, q.device)
        fn = build.function('flash_decode', 'flash_decode_paged', _K1_ARGS)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 pos.data_ptr(), window.data_ptr(), block_tables.data_ptr(),
                 *(t.data_ptr() for t in part), out.data_ptr(), b, hkv, rows,
                 dh, page_size, w, *_plan_args(plan), float(scale), is_bf16,
                 build.stream_of(q))
        build.check(err, 'flash_decode', name)
        build.count('flash_decode_paged')
    else:
        plan = chunk_split_plan(b, w, page_size, hkv * ways, chunk,
                                rows // chunk, dh, k_pages.element_size())
        part, out = _split_scratch(b, hkv, rows, dh, plan, q.device)
        fn = build.function('flash_decode', 'flash_chunk_paged', _K5_ARGS)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 pos.data_ptr(), window.data_ptr(), offset.data_ptr(),
                 block_tables.data_ptr(), *(t.data_ptr() for t in part),
                 out.data_ptr(), b, hkv, rows, dh, page_size, w, chunk,
                 *_plan_args(plan), float(scale), is_bf16,
                 build.stream_of(q))
        build.check(err, 'flash_decode', name)
        build.count('flash_chunk_paged')
    return out


def flash_decode_gqa_paged_q8(q, k_pages, v_pages, kq_pages, vq_pages,
                              k_scales, v_scales, pos, window, block_tables,
                              hot_window, *, scale: float,
                              ways: int = 1) -> torch.Tensor:
    """Kernel K6; same contract as :func:`flash_decode_gqa_paged_q8_plain`.
    On CUDA: f32 query, bf16 or f32 fp pools, int8 pools of the same shape,
    f32 (P, Hkv) scales, int32 pos/window/tables and a (1,) int32 hot
    window, read by the kernel from device memory (no host sync).
    ``ways`` as :func:`flash_decode_gqa_paged`'s."""
    tensors = (q, k_pages, v_pages, kq_pages, vq_pages, k_scales, v_scales,
               pos, window, block_tables, hot_window)
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_decode_gqa_paged_q8_plain(
            q, k_pages, v_pages, kq_pages, vq_pages, k_scales, v_scales, pos,
            window, block_tables, hot_window, scale=scale)
    name = 'flash_decode_gqa_paged_q8'
    b, hkv, g, dh, page_size, w = _check_paged(name, q, k_pages, v_pages,
                                               pos, window, block_tables)
    n_pages = k_pages.shape[0]
    if (kq_pages.shape != k_pages.shape or vq_pages.shape != k_pages.shape
            or tuple(k_scales.shape) != (n_pages, hkv)
            or tuple(v_scales.shape) != (n_pages, hkv)
            or tuple(hot_window.shape) != (1,)):
        raise ValueError(
            f'{name}: int8 pools {tuple(kq_pages.shape)}/'
            f'{tuple(vq_pages.shape)}, scales {tuple(k_scales.shape)}/'
            f'{tuple(v_scales.shape)}, hot window {tuple(hot_window.shape)} '
            f'for fp pools {tuple(k_pages.shape)}')
    i8, f32 = (torch.int8,), (torch.float32,)
    build.require_cuda(name, *tensors,
                       dtypes=[f32, _FP, _FP, i8, i8, f32, f32, _I32, _I32,
                               _I32, _I32])
    plan = paged_split_plan(b, w, page_size, hkv * ways, g, dh,
                            k_pages.element_size())
    part, out = _split_scratch(b, hkv, g, dh, plan, q.device)
    fn = build.function('flash_decode', 'flash_decode_paged_q8', _K6_ARGS)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             kq_pages.data_ptr(), vq_pages.data_ptr(), k_scales.data_ptr(),
             v_scales.data_ptr(), hot_window.data_ptr(), pos.data_ptr(),
             window.data_ptr(), block_tables.data_ptr(),
             *(t.data_ptr() for t in part), out.data_ptr(), b, hkv, g, dh,
             page_size, w, *_plan_args(plan), float(scale),
             int(k_pages.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, 'flash_decode', name)
    build.count('flash_decode_paged_q8')
    return out


def flash_decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: torch.Tensor, *,
                     scale: float, prefetch: bool = True,
                     ways: int = 1) -> torch.Tensor:
    """Kernel K7; same contract as :func:`flash_decode_gqa_plain`. On CUDA
    the query must be f32, the cache bf16 or f32 (one dtype), pos and
    window int32; no padding copy is made. One launch runs two kernels,
    the key splits of :func:`contig_split_plan` and their combine, with the
    splits' partials in scratch allocated here. ``ways``: the degree the
    KV heads were split over (a mesh rank's heads); the plan is made for
    all ``Hkv * ways`` heads, so each head's keys split as at ``ways`` 1.
    Meta tensors take the shape-only route (``kernels/meta.py``)."""
    tensors = (q, k, v, pos, window)
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_decode_gqa_plain(q, k, v, pos, window, scale=scale,
                                      prefetch=prefetch)
    if meta.on_meta(*tensors):
        return meta.flash_decode_gqa(q, k, v, pos, window)
    name = 'flash_decode_gqa'
    b, hkv, g, dh = q.shape
    s_max = k.shape[1]
    if (tuple(k.shape) != (b, s_max, hkv, dh) or v.shape != k.shape
            or v.dtype != k.dtype or tuple(pos.shape) != (b,)
            or tuple(window.shape) != (b,)):
        raise ValueError(
            f'{name}: q {tuple(q.shape)}, cache {tuple(k.shape)}/'
            f'{tuple(v.shape)} ({k.dtype}/{v.dtype}), pos '
            f'{tuple(pos.shape)}, window {tuple(window.shape)}')
    build.require_cuda(name, *tensors,
                       dtypes=[(torch.float32,), _FP, _FP, _I32, _I32])
    plan = contig_split_plan(b, s_max, hkv * ways, g, dh, k.element_size())
    part, out = _split_scratch(b, hkv, g, dh, plan, q.device)
    fn = build.function('flash_decode', 'flash_decode_contig', _K7_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             window.data_ptr(), *(t.data_ptr() for t in part),
             out.data_ptr(), b, s_max, hkv, g, dh, *_plan_args(plan),
             float(scale), int(k.dtype == torch.bfloat16),
             int(not prefetch), build.stream_of(q))
    build.check(err, 'flash_decode', name)
    build.count('flash_decode_contig')
    return out


def _check_latent(name, q, c_pages, pos, window, block_tables, r):
    """Shape checks shared by the MLA kernel wrappers; returns
    (b, rows, dk, page_size, w)."""
    b, one, rows, dk = q.shape
    w = block_tables.shape[1]
    if (one != 1 or c_pages.ndim != 3 or c_pages.shape[2] != dk
            or not 0 < r < dk or tuple(pos.shape) != (b,)
            or tuple(window.shape) != (b,)
            or tuple(block_tables.shape) != (b, w)):
        raise ValueError(
            f'{name}: q {tuple(q.shape)}, latent pool '
            f'{tuple(c_pages.shape)}, r={r}, pos {tuple(pos.shape)}, window '
            f'{tuple(window.shape)}, tables {tuple(block_tables.shape)}')
    return b, rows, dk, c_pages.shape[1], w


def flash_decode_mla_paged(q: torch.Tensor, c_pages: torch.Tensor,
                           pos: torch.Tensor, window: torch.Tensor,
                           block_tables: torch.Tensor, offset=None, *,
                           scale: float, r: int, chunk: int = 1,
                           ways: int = 1) -> torch.Tensor:
    """Same contract as :func:`flash_decode_mla_paged_plain`: kernel K8
    (``chunk == 1``) or K9 (``chunk > 1``). On CUDA the query must be f32,
    the latent pool bf16 or f32, and pos, window, offset and block tables
    int32. Both run two device kernels, the latent splits of
    :func:`latent_split_plan` (over the R query rows, C·H for a chunk) and
    their combine, with the splits' partials in scratch allocated here.
    Rows of a chunk past its limit (padding) stay finite but may differ
    from the plain version's: the kernel reads no key past the fetch-union
    position. ``ways``: the tensor-parallel degree the heads were split
    over; the plan is made for all ``R * ways`` rows, so each (request,
    head)'s keys are cut as on one device."""
    tensors = (q, c_pages, pos, window, block_tables) + (
        () if offset is None else (offset,))
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_decode_mla_paged_plain(q, c_pages, pos, window,
                                            block_tables, offset,
                                            scale=scale, r=r, chunk=chunk)
    name = 'flash_decode_mla_paged'
    b, rows, dk, page_size, w = _check_latent(name, q, c_pages, pos, window,
                                              block_tables, r)
    if (offset is None) != (chunk == 1) or rows % chunk \
            or (offset is not None and tuple(offset.shape) != (b,)):
        raise ValueError(f'{name}: chunk={chunk} needs a (B,) offset and '
                         f'rows % chunk == 0 (rows={rows})')
    build.require_cuda(name, *tensors,
                       dtypes=[(torch.float32,), _FP, _I32, _I32, _I32,
                               _I32])
    plan = latent_split_plan(b, w, page_size, rows * ways, dk, r,
                             c_pages.element_size())
    part, out = _split_scratch(b, 1, rows, r, plan, q.device)
    # K9's entry point also takes the chunk's offsets and its length
    if chunk == 1:
        kernel, argtypes, off, c = 'flash_decode_paged_mla', _K8_ARGS, (), ()
    else:
        kernel, argtypes = 'flash_chunk_paged_mla', _K9_ARGS
        off, c = (offset.data_ptr(),), (chunk,)
    fn = build.function('flash_decode', kernel, argtypes)
    err = fn(q.data_ptr(), c_pages.data_ptr(), pos.data_ptr(),
             window.data_ptr(), *off, block_tables.data_ptr(),
             *(t.data_ptr() for t in part), out.data_ptr(), b, rows, dk, r,
             page_size, w, *c, *_latent_plan_args(plan), float(scale),
             int(c_pages.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, 'flash_decode', name)
    build.count(kernel)
    return out


def flash_decode_mla_paged_q8(q, c_pages, cq_pages, c_scales, pos, window,
                              block_tables, hot_window, *, scale: float,
                              r: int, ways: int = 1) -> torch.Tensor:
    """Kernel K10; same contract as :func:`flash_decode_mla_paged_q8_plain`.
    On CUDA: f32 query, bf16 or f32 latent pool, an int8 pool of the same
    shape, f32 (P, 1) scales, int32 pos/window/tables and a (1,) int32 hot
    window, read by the kernel from device memory (no host sync).
    ``ways`` as :func:`flash_decode_mla_paged`'s."""
    tensors = (q, c_pages, cq_pages, c_scales, pos, window, block_tables,
               hot_window)
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_decode_mla_paged_q8_plain(
            q, c_pages, cq_pages, c_scales, pos, window, block_tables,
            hot_window, scale=scale, r=r)
    name = 'flash_decode_mla_paged_q8'
    b, h, dk, page_size, w = _check_latent(name, q, c_pages, pos, window,
                                           block_tables, r)
    if (cq_pages.shape != c_pages.shape
            or tuple(c_scales.shape) != (c_pages.shape[0], 1)
            or tuple(hot_window.shape) != (1,)):
        raise ValueError(
            f'{name}: int8 pool {tuple(cq_pages.shape)}, scales '
            f'{tuple(c_scales.shape)}, hot window {tuple(hot_window.shape)} '
            f'for latent pool {tuple(c_pages.shape)}')
    build.require_cuda(name, *tensors,
                       dtypes=[(torch.float32,), _FP, (torch.int8,),
                               (torch.float32,), _I32, _I32, _I32, _I32])
    plan = latent_split_plan(b, w, page_size, h * ways, dk, r,
                             c_pages.element_size())
    part, out = _split_scratch(b, 1, h, r, plan, q.device)
    fn = build.function('flash_decode', 'flash_decode_paged_mla_q8',
                        _K10_ARGS)
    err = fn(q.data_ptr(), c_pages.data_ptr(), cq_pages.data_ptr(),
             c_scales.data_ptr(), hot_window.data_ptr(), pos.data_ptr(),
             window.data_ptr(), block_tables.data_ptr(),
             *(t.data_ptr() for t in part), out.data_ptr(), b, h, dk, r,
             page_size, w, *_latent_plan_args(plan), float(scale),
             int(c_pages.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, 'flash_decode', name)
    build.count('flash_decode_paged_mla_q8')
    return out


def _norm_scalar_vec(x, b: int, device, fill=None) -> torch.Tensor:
    """None | int | 0-d | (B,)/(B,1) tensor -> (B,) int32 on ``device``."""
    if x is None:
        return torch.full((b,), fill, dtype=torch.int32, device=device)
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.reshape(-1).expand(b).contiguous() if x.numel() == 1 \
        else x.reshape(b).contiguous()


def _decode_operands(q, k_pages, block_tables, pos, window):
    """(q grouped (B, Hkv, G, dh) f32, pos, window, tables) for a decode
    wrapper; q is (B, 1, H, dh) or (B, H, dh)."""
    if q.ndim == 4:
        if q.shape[1] != 1:
            raise ValueError(f'decode query must have one token, got '
                             f'{tuple(q.shape)}')
        q = q[:, 0]
    b, h, dh = q.shape
    hkv = k_pages.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh).to(torch.float32).contiguous()
    s_logical = block_tables.shape[1] * k_pages.shape[1]
    dev = q.device
    return (qg, _norm_scalar_vec(pos, b, dev),
            _norm_scalar_vec(window, b, dev, fill=s_logical + 1),
            block_tables.to(torch.int32).contiguous())


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 scale: float, window=None,
                 impl: str = 'prefetch', ways: int = 1) -> torch.Tensor:
    """Shape-flexible wrapper around :func:`flash_decode_gqa` (K7).

    q: (B, 1, H, dh) or (B, H, dh); k/v: (B, S_max, Hkv, dh); pos: scalar
    or (B,); window: None (filled with S_max + 1), int or (B,). ``impl``:
    'prefetch' (live key tiles only) or 'streamed' (every tile, the
    reference's legacy baseline; bit-equal output); ``ways`` as
    :func:`flash_decode_gqa`'s. Returns attention
    output shaped like q, in v.dtype (the one conversion back to the
    serving dtype happens here, after the fused normalize)."""
    if impl not in ('prefetch', 'streamed'):
        raise ValueError(f'impl must be prefetch or streamed, got {impl!r}')
    squeeze = q.ndim == 4
    if squeeze:
        if q.shape[1] != 1:
            raise ValueError(f'decode query must have one token, got '
                             f'{tuple(q.shape)}')
        q = q[:, 0]
    b, h, dh = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh).to(torch.float32).contiguous()
    out = flash_decode_gqa(qg, k, v, _norm_scalar_vec(pos, b, q.device),
                           _norm_scalar_vec(window, b, q.device,
                                            fill=s_max + 1),
                           scale=scale, prefetch=impl == 'prefetch',
                           ways=ways)
    out = out.reshape(b, h, dh).to(v.dtype)
    return out[:, None] if squeeze else out


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, pos, block_tables: torch.Tensor,
                       *, scale: float, window=None,
                       ways: int = 1) -> torch.Tensor:
    """Shape-flexible wrapper around :func:`flash_decode_gqa_paged` (K1).

    q: (B, 1, H, dh) or (B, H, dh); k/v_pages: (P, page_size, Hkv, dh);
    pos: scalar or (B,); block_tables: (B, W) int. Returns attention output
    shaped like q, in v_pages.dtype (the one conversion back to the serving
    dtype happens here, after the fused normalize)."""
    qg, posv, win, bt = _decode_operands(q, k_pages, block_tables, pos,
                                         window)
    out = flash_decode_gqa_paged(qg, k_pages, v_pages, posv, win, bt,
                                 scale=scale, ways=ways)
    return out.reshape(q.shape).to(v_pages.dtype)


def flash_decode_paged_q8(q, k_pages, v_pages, kq_pages, vq_pages, k_scales,
                          v_scales, pos, block_tables, hot_window, *,
                          scale: float, window=None,
                          ways: int = 1) -> torch.Tensor:
    """Shape-flexible wrapper around :func:`flash_decode_gqa_paged_q8`
    (K6): as :func:`flash_decode_paged`, plus the int8 pools, their (P, Hkv)
    scales and the hot window (int or (1,) tensor)."""
    qg, posv, win, bt = _decode_operands(q, k_pages, block_tables, pos,
                                         window)
    hw = torch.as_tensor(hot_window, dtype=torch.int32,
                         device=q.device).reshape(-1)[:1].contiguous()
    out = flash_decode_gqa_paged_q8(qg, k_pages, v_pages, kq_pages, vq_pages,
                                    k_scales, v_scales, posv, win, bt, hw,
                                    scale=scale, ways=ways)
    return out.reshape(q.shape).to(v_pages.dtype)


def _chunk_scalars(offset, limit, window, b: int, c: int, s_logical: int,
                   device):
    """Fetch-union scalars for a chunk of ``c`` query rows starting at
    ``offset``: pos = the chunk's last valid position (clamped below
    ``limit`` so block-table indexing never walks past the prompt's pages),
    window = the per-row window widened by (c - 1), so the live-block range
    covers the earliest row's reach."""
    offv = _norm_scalar_vec(offset, b, device)
    limv = _norm_scalar_vec(limit, b, device)
    posv = torch.minimum(torch.maximum(limv - 1, offv), offv + (c - 1))
    winv = _norm_scalar_vec(window, b, device, fill=s_logical + 1) + (c - 1)
    return offv, posv.contiguous(), winv.contiguous()


def flash_chunk_paged(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, offset, limit,
                      block_tables: torch.Tensor, *, scale: float,
                      window=None, ways: int = 1) -> torch.Tensor:
    """Chunked-prefill GQA attention over a paged KV pool (K5): the chunk's
    C query tokens (absolute positions offset .. offset + C - 1) causally
    attend everything already written for the request, the chunk's own rows
    included (write the chunk to the pool first).

    q: (B, C, H, dh); k/v_pages: (P, page_size, Hkv, dh); offset/limit:
    scalar or (B,) — rows at positions >= limit are padding (finite
    garbage the caller discards); block_tables: (B, W) int. Returns
    (B, C, H, dh) in v_pages.dtype."""
    b, c, h, dh = q.shape
    hkv = k_pages.shape[2]
    g = h // hkv
    # (B, C, Hkv, G, dh) -> (B, Hkv, C, G, dh): rows = C * G per KV head
    qg = q.reshape(b, c, hkv, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, c * g, dh).to(torch.float32).contiguous()
    s_logical = block_tables.shape[1] * k_pages.shape[1]
    offv, posv, winv = _chunk_scalars(offset, limit, window, b, c, s_logical,
                                      q.device)
    out = flash_decode_gqa_paged(qg, k_pages, v_pages, posv, winv,
                                 block_tables.to(torch.int32).contiguous(),
                                 offv, scale=scale, chunk=c, ways=ways)
    out = out.reshape(b, hkv, c, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, h, dh)
    return out.to(v_pages.dtype)


def _mla_decode_operands(q, c_pages, pos, block_tables, window):
    """(q (B, 1, H, dk) f32, pos, window, tables, had_q_axis) for an MLA
    decode wrapper; q is (B, 1, H, dk) or (B, H, dk)."""
    had_q_axis = q.ndim == 4
    if had_q_axis:
        if q.shape[1] != 1:
            raise ValueError(f'decode query must have one token, got '
                             f'{tuple(q.shape)}')
    else:
        q = q[:, None]
    b = q.shape[0]
    s_logical = block_tables.shape[1] * c_pages.shape[1]
    dev = q.device
    return (q.to(torch.float32).contiguous(), _norm_scalar_vec(pos, b, dev),
            _norm_scalar_vec(window, b, dev, fill=s_logical + 1),
            block_tables.to(torch.int32).contiguous(), had_q_axis)


def flash_decode_paged_mla(q: torch.Tensor, c_pages: torch.Tensor, pos,
                           block_tables: torch.Tensor, *, r: int,
                           scale: float, window=None,
                           ways: int = 1) -> torch.Tensor:
    """Shape-flexible wrapper around :func:`flash_decode_mla_paged` (K8).

    q: (B, 1, H, r + d_rope) or (B, H, r + d_rope), the absorbed+rope
    query; c_pages: (P, page_size, r + d_rope) latent pool; pos: scalar or
    (B,); block_tables: (B, W) int. Returns the latent output shaped like
    q with last dim ``r``, in f32 (the caller applies ``W_uv``)."""
    q4, posv, win, bt, had_q_axis = _mla_decode_operands(
        q, c_pages, pos, block_tables, window)
    out = flash_decode_mla_paged(q4, c_pages, posv, win, bt, scale=scale,
                                 r=r, ways=ways)
    return out if had_q_axis else out[:, 0]


def flash_decode_paged_mla_q8(q, c_pages, cq_pages, c_scales, pos,
                              block_tables, hot_window, *, r: int,
                              scale: float, window=None,
                              ways: int = 1) -> torch.Tensor:
    """Shape-flexible wrapper around :func:`flash_decode_mla_paged_q8`
    (K10): as :func:`flash_decode_paged_mla`, plus the int8 latent pool,
    its (P, 1) or (P,) scales and the hot window (int or (1,) tensor)."""
    q4, posv, win, bt, had_q_axis = _mla_decode_operands(
        q, c_pages, pos, block_tables, window)
    hw = torch.as_tensor(hot_window, dtype=torch.int32,
                         device=q.device).reshape(-1)[:1].contiguous()
    cs = c_scales.to(torch.float32).reshape(c_pages.shape[0], 1) \
        .contiguous()
    out = flash_decode_mla_paged_q8(q4, c_pages, cq_pages, cs, posv, win,
                                    bt, hw, scale=scale, r=r, ways=ways)
    return out if had_q_axis else out[:, 0]


def flash_chunk_paged_mla(q: torch.Tensor, c_pages: torch.Tensor, offset,
                          limit, block_tables: torch.Tensor, *, r: int,
                          scale: float, window=None,
                          ways: int = 1) -> torch.Tensor:
    """Chunked-prefill absorbed-MLA attention over a paged latent pool
    (K9): :func:`flash_chunk_paged`'s contract with the absorbed query of
    :func:`flash_decode_paged_mla`.

    q: (B, C, H, r + d_rope); c_pages: (P, page_size, r + d_rope);
    offset/limit: scalar or (B,); block_tables: (B, W) int. Returns
    (B, C, H, r) f32 (the caller applies ``W_uv``)."""
    b, c, h, dk = q.shape
    # row i -> head i % H at position offset + i // H
    qg = q.reshape(b, 1, c * h, dk).to(torch.float32).contiguous()
    s_logical = block_tables.shape[1] * c_pages.shape[1]
    offv, posv, winv = _chunk_scalars(offset, limit, window, b, c, s_logical,
                                      q.device)
    out = flash_decode_mla_paged(qg, c_pages, posv, winv,
                                 block_tables.to(torch.int32).contiguous(),
                                 offv, scale=scale, r=r, chunk=c, ways=ways)
    return out.reshape(b, c, h, r)
