"""Paged KV cache: fixed-size pages, per-request block tables, free-list
allocation (port of ``repro/runtime/kv_cache.py``).

* :class:`PagedKVCache` — the host-side allocator in plain numpy: free
  list, per-slot block tables, alloc / ensure / release, the pool-squeeze
  reservations and the scrub queue the quarantine path drains, and the
  ``check_invariants`` audit, and (``prefix_cache=True``) the refcounted,
  content-keyed prefix cache with copy-on-write admission plans.
* pure pool ops (``paged_token_update`` / ``paged_prefill_update`` /
  ``paged_chunk_update`` / ``gather_pages`` / ``scatter_pages``). Unlike
  the reference's functional updates, the port writes pools IN PLACE and
  returns the same tensor.

Page 0 is the reserved garbage page: never allocated, idle slots' table
rows point at it, and reads from it are always masked.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Set

import numpy as np
import torch

GARBAGE_PAGE = 0


# ----------------------------------------------------------------------------
# host-side allocator
# ----------------------------------------------------------------------------
class PagedKVCache:
    """Free-list page allocator with per-slot block tables and (opt-in)
    refcounted prefix sharing.

    ``num_pages`` counts the whole pool including the reserved garbage
    page 0, matching the physical pool's leading dim. ``max_blocks`` is the
    block-table width W — it bounds both the longest admissible sequence
    (W * page_size positions) and the paged kernel's S grid dimension.

    Prefix cache (``prefix_cache=True``)
    ------------------------------------
    Pages holding a request's *full* prompt blocks can be **sealed** after
    prefill (:meth:`seal_slot`): sealed pages are immutable and published
    into a prefix hash table keyed on the cumulative prompt-token content
    ``prompt[:(i + 1) * page_size]`` (collision-free: the key IS the
    content). A later admission whose prompt starts with the same token
    blocks acquires the sealed pages by reference (:meth:`admit_prompt`)
    instead of re-allocating and re-prefilling them:

    * ``refs[page]`` counts table references; :meth:`release` decrements
      instead of freeing, so a shared page survives its first owner.
    * A sealed page whose refcount drops to 0 parks in an LRU *evictable*
      set — still cached (future admissions resurrect it) but reclaimable:
      the allocator evicts the oldest evictable page whenever the free
      list runs dry, so caching never blocks an admission that plain
      allocation could have served.
    * A fully-covered prompt copy-on-writes exactly the one boundary page
      its first write (the last-token recompute) would land in; partial
      covers prefill the unshared suffix into private pages and never
      write a shared page at all. ``check_invariants`` audits the
      discipline: multi-referenced pages are always sealed, unsealed
      pages never have more than one owner.

    With ``prefix_cache=False`` (the default) no page is ever sealed and
    the allocator behaves exactly like the historical free-list one.
    """

    def __init__(self, num_pages: int, page_size: int, max_blocks: int,
                 slots: int, *, prefix_cache: bool = False):
        assert num_pages >= 2, 'need at least one allocatable page'
        assert page_size >= 1 and max_blocks >= 1 and slots >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_blocks = max_blocks
        self.slots = slots
        self.prefix_cache = bool(prefix_cache)
        # LIFO free list: hot pages get reused first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.tables = np.zeros((slots, max_blocks), np.int32)
        self.counts = np.zeros((slots,), np.int32)   # blocks held per slot
        # pages held out of circulation by fault injection (pool squeeze):
        # neither free nor owned, but still accounted by check_invariants
        self.reserved: List[int] = []
        # -- prefix-sharing state (all empty when prefix_cache is off) -------
        self.refs = np.zeros((num_pages,), np.int32)  # table refs per page
        self.sealed: Set[int] = set()                 # immutable pages
        self.shared_blocks = np.zeros((slots,), np.int32)  # leading sealed
        self._prefix: Dict[bytes, int] = {}           # content key -> page
        self._page_key: Dict[int, bytes] = {}         # page -> content key
        self._evictable: 'OrderedDict[int, None]' = OrderedDict()  # LRU
        self._scrub_deferred: Set[int] = set()        # scrub on last release
        self.scrub_queue: List[int] = []              # freed, awaiting scrub
        self.quantized_pages: Set[int] = set()        # int8 tier up to date
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.cow_copies = 0

    # -- capacity ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Sealed refcount-0 pages parked in the evictable LRU."""
        return len(self._evictable)

    @property
    def free_capacity(self) -> int:
        """Pages an allocation can draw on: truly free plus evictable."""
        return len(self._free) + len(self._evictable)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.free_capacity

    @property
    def owned_pages(self) -> int:
        """Distinct pages backing slot tables (used minus squeezed); a
        page shared by four slots counts once."""
        return self.used_pages - len(self.reserved)

    @property
    def shared_pages(self) -> int:
        """Pages referenced by more than one slot table."""
        return int(np.sum(self.refs >= 2))

    def occupancy(self) -> dict:
        """Pool occupancy for the telemetry gauges: every allocatable page
        is free, reserved (held by a pool squeeze), cached (sealed,
        refcount 0, evictable) or owned by a slot, the partition
        :meth:`check_invariants` audits; ``shared`` is the multi-owner
        subset of ``owned``."""
        return dict(free=len(self._free), reserved=len(self.reserved),
                    cached=len(self._evictable),
                    owned=self.owned_pages, shared=self.shared_pages,
                    allocatable=self.num_pages - 1)

    def blocks_for(self, n_positions: int) -> int:
        return -(-n_positions // self.page_size)

    # -- prefix keys ---------------------------------------------------------
    def _page_keys(self, prompt) -> List[bytes]:
        """Cumulative content keys of the prompt's FULL token blocks:
        key i covers ``prompt[:(i + 1) * page_size]``, so a chain of
        matches is inherently consistent (no hash collisions — the key is
        the content)."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32).ravel())
        ps = self.page_size
        return [toks[:(i + 1) * ps].tobytes()
                for i in range(len(toks) // ps)]

    def _take_free_page(self) -> int:
        """Pop a page for allocation: the free list first, else evict the
        least-recently-released cached page (dropping its prefix entry)."""
        if self._free:
            return self._free.pop()
        page, _ = self._evictable.popitem(last=False)
        key = self._page_key.pop(page)
        del self._prefix[key]
        self.sealed.discard(page)
        self.quantized_pages.discard(page)
        self.prefix_evictions += 1
        return page

    # -- alloc / release -----------------------------------------------------
    def alloc_blocks(self, slot: int, n: int) -> bool:
        """Append ``n`` private pages to ``slot``'s table. All-or-nothing:
        returns False (no state change) if the free capacity or the table
        can't cover it — the scheduler's signal to stop admitting or to
        preempt."""
        have = int(self.counts[slot])
        if n <= 0:
            return True
        if n > self.free_capacity or have + n > self.max_blocks:
            return False
        for i in range(n):
            page = self._take_free_page()
            self.tables[slot, have + i] = page
            self.refs[page] = 1
        self.counts[slot] = have + n
        return True

    def admit_prompt(self, slot: int, prompt,
                     pad_positions: Optional[int] = None) -> Optional[dict]:
        """Admission-time allocation for ``slot``'s prompt, with prefix
        sharing when enabled. Returns an admission plan dict or None if
        the pool / table can't cover it (no state change):

        ``hit``            whether any prefix block was shared
        ``shared``         leading table blocks pointing at sealed pages
        ``prefill_start``  first prompt position the serve loop must compute
                           (0 = full prefill; ``len(prompt) - 1`` = the
                           fully-covered last-token recompute)
        ``cow``            None, or ``(src, dst)`` physical pages: the
                           serve loop must copy page ``src`` onto ``dst``
                           before the prefill step writes into it

        With ``prefix_cache=False`` this is exactly the historical path:
        allocate ``blocks_for(pad_positions)`` private pages and prefill
        the whole (padded) prompt. ``pad_positions`` defaults to the
        prompt length."""
        plen = int(np.asarray(prompt).size)
        if pad_positions is None:
            pad_positions = plen
        assert int(self.counts[slot]) == 0, \
            f'slot {slot} still holds {int(self.counts[slot])} blocks'
        if not self.prefix_cache:
            if self.alloc_blocks(slot, self.blocks_for(pad_positions)):
                return dict(hit=False, shared=0, prefill_start=0, cow=None)
            return None
        ps = self.page_size
        keys = self._page_keys(prompt)
        n_match = 0
        for key in keys:
            if key not in self._prefix:
                break
            n_match += 1
        total = self.blocks_for(plen)
        full_cover = n_match > 0 and n_match * ps == plen
        # full cover: the last-token recompute writes into the final
        # prompt block, so that one boundary page is copy-on-write — share
        # one page less and allocate a private copy target instead
        n_shared = n_match - 1 if full_cover else n_match
        cow_src = self._prefix[keys[n_match - 1]] if full_cover else None
        if total > self.max_blocks:
            return None
        # private capacity: evictable pages we are about to resurrect as
        # shared (refs 0 -> 1) can't also be evicted for the private part,
        # and neither can a refcount-0 COW source
        resurrect = sum(1 for i in range(n_shared)
                        if int(self.refs[self._prefix[keys[i]]]) == 0)
        pinned = (cow_src is not None
                  and int(self.refs[cow_src]) == 0)
        if total - n_shared > self.free_capacity - resurrect - int(pinned):
            return None
        if pinned:
            self._evictable.pop(cow_src)
        for i in range(n_shared):
            page = self._prefix[keys[i]]
            if int(self.refs[page]) == 0:
                self._evictable.pop(page)
            self.refs[page] += 1
            self.tables[slot, i] = page
        for i in range(n_shared, total):
            page = self._take_free_page()
            self.tables[slot, i] = page
            self.refs[page] = 1
        if pinned:
            self._evictable[cow_src] = None   # back at the MRU end
        self.counts[slot] = total
        self.shared_blocks[slot] = n_shared
        cow = None
        if full_cover:
            cow = (int(cow_src), int(self.tables[slot, n_shared]))
            self.cow_copies += 1
            prefill_start = plen - 1
        else:
            prefill_start = n_match * ps
        if n_match:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        return dict(hit=n_match > 0, shared=n_shared,
                    prefill_start=prefill_start, cow=cow)

    def seal_slot(self, slot: int, prompt) -> int:
        """Publish ``slot``'s full prompt blocks into the prefix table
        (call AFTER the prefill that filled them — sealing promises the
        content is final). Stops at the first key another slot already
        published (its page stays canonical; this slot's copy stays
        private), which keeps every slot's sealed blocks a contiguous
        leading run. Returns how many new pages were sealed."""
        if not self.prefix_cache:
            return 0
        keys = self._page_keys(prompt)
        start = int(self.shared_blocks[slot])
        sealed_new = 0
        for i in range(start, len(keys)):
            key = keys[i]
            if key in self._prefix:
                break
            page = int(self.tables[slot, i])
            self._prefix[key] = page
            self._page_key[page] = key
            self.sealed.add(page)
            self.shared_blocks[slot] = i + 1
            sealed_new += 1
        return sealed_new

    def ensure(self, slot: int, pos: int) -> bool:
        """Grow ``slot`` so position ``pos`` is backed by a page (the
        decode-step contract: call before the step that writes at pos)."""
        need = pos // self.page_size + 1 - int(self.counts[slot])
        return self.alloc_blocks(slot, need)

    def _release_page(self, page: int) -> None:
        self.refs[page] -= 1
        assert int(self.refs[page]) >= 0, f'page {page} over-released'
        if int(self.refs[page]) > 0:
            return
        if page in self.sealed and page in self._page_key:
            # cached: keep content + prefix entry, park in the LRU
            self._evictable[page] = None
            self._evictable.move_to_end(page)
            return
        # private page, or a retired (quarantined) shared page
        self.sealed.discard(page)
        self.quantized_pages.discard(page)
        if page in self._scrub_deferred:
            self._scrub_deferred.discard(page)
            self.scrub_queue.append(page)
        self._free.append(page)

    def release(self, slot: int) -> None:
        """Drop every page reference of ``slot`` (eviction / completion).
        Sole-owner private pages return to the free list; sealed pages
        survive as cached (evictable) entries or stay with their other
        owners. The table row resets to the garbage page."""
        held = int(self.counts[slot])
        for i in range(held):
            self._release_page(int(self.tables[slot, i]))
        self.tables[slot, :] = GARBAGE_PAGE
        self.counts[slot] = 0
        self.shared_blocks[slot] = 0

    # -- quarantine / retirement ---------------------------------------------
    def retire_page(self, page: int) -> None:
        """Remove a page from the prefix cache (content suspect): no
        future admission can acquire it. Owners still holding references
        keep reading it (it stays sealed until the last release); a
        refcount-0 cached page is pulled from the evictable LRU, freed,
        and queued for scrubbing."""
        key = self._page_key.pop(page, None)
        if key is not None:
            del self._prefix[key]
        if int(self.refs[page]) == 0 and page in self._evictable:
            self._evictable.pop(page)
            self.sealed.discard(page)
            self.quantized_pages.discard(page)
            self._scrub_deferred.discard(page)
            self.scrub_queue.append(page)
            self._free.append(page)

    def defer_scrub(self, slot: int) -> List[int]:
        """Mark every page ``slot`` holds scrub-before-reuse and retire it
        from the prefix cache, WITHOUT releasing the slot (the scheduler's
        quarantine path releases through its own teardown). A marked page
        reaches :attr:`scrub_queue` only when its LAST reference drops —
        a page another slot still references is never scrubbed in place
        (it stays sealed and readable by its other owners, who trip the
        integrity sentinel themselves if it is truly poisoned). Returns
        the pages marked."""
        held = int(self.counts[slot])
        pages = [int(self.tables[slot, i]) for i in range(held)]
        for page in pages:
            self._scrub_deferred.add(page)
            self.retire_page(page)
        return pages

    def drain_scrub_queue(self) -> List[int]:
        """Pages freed since the last drain that must be zeroed before
        reallocation (quarantined content). The serve loop scrubs them on the
        device and only then admits new work."""
        q, self.scrub_queue = self.scrub_queue, []
        return q

    def owners_of(self, page: int) -> List[int]:
        """Slots whose tables reference ``page`` (the chaos layer marks
        every owner of a poisoned shared page as touched)."""
        out = []
        for slot in range(self.slots):
            held = int(self.counts[slot])
            if held and bool(np.any(self.tables[slot, :held] == page)):
                out.append(slot)
        return out

    # -- fault injection (pool squeeze) --------------------------------------
    def reserve_pages(self, n: int) -> int:
        """Hold up to ``n`` free pages out of circulation (the chaos
        layer's pool-squeeze fault). Returns how many were actually taken;
        owned pages are never touched."""
        take = min(max(n, 0), len(self._free))
        for _ in range(take):
            self.reserved.append(self._free.pop())
        return take

    def unreserve_pages(self, n: Optional[int] = None) -> int:
        """Return ``n`` reserved pages (default: all) to the free list."""
        give = len(self.reserved) if n is None else \
            min(max(n, 0), len(self.reserved))
        for _ in range(give):
            self._free.append(self.reserved.pop())
        return give

    # -- integrity audit -----------------------------------------------------
    def check_invariants(self) -> None:
        """Free-list / reserved / cached / block-table consistency audit.
        Raises ValueError on the first violation; chaos and prefix tests
        run this after every scheduler step. Invariants:

        * every free/reserved/cached/owned page index is in [1, num_pages);
        * the garbage page 0 is never free, reserved, cached, or owned;
        * ``refs[page]`` equals the number of table references, a page
          referenced more than once is sealed, an unsealed page has at
          most one owner (no unsynchronized write target is ever shared);
        * each slot's leading ``shared_blocks`` blocks are sealed and the
          rest are private (refcount 1, unsealed);
        * the prefix table is a bijection onto sealed pages; evictable
          pages are sealed, refcount 0, and still in the prefix table;
        * free + reserved + cached + Σ-unique-owned partition the
          allocatable pool exactly;
        * each table row's tail beyond ``counts[slot]`` is all garbage.
        """
        def bad(msg):
            raise ValueError(f'PagedKVCache invariant violated: {msg}')

        owned: dict = {}            # page -> first (slot, block) reference
        ref_count: dict = {}        # page -> table references counted
        for slot in range(self.slots):
            held = int(self.counts[slot])
            if not 0 <= held <= self.max_blocks:
                bad(f'slot {slot} counts={held} outside '
                    f'[0, {self.max_blocks}]')
            shared = int(self.shared_blocks[slot])
            if not 0 <= shared <= held:
                bad(f'slot {slot} shared_blocks={shared} outside '
                    f'[0, counts={held}]')
            for i in range(held):
                page = int(self.tables[slot, i])
                if not 1 <= page < self.num_pages:
                    bad(f'slot {slot} block {i} points at page {page} '
                        f'(garbage page or out of range)')
                if page in owned and page not in self.sealed:
                    bad(f'unsealed page {page} owned twice: slot/block '
                        f'{owned[page]} and ({slot}, {i})')
                owned.setdefault(page, (slot, i))
                ref_count[page] = ref_count.get(page, 0) + 1
                if i < shared and page not in self.sealed:
                    bad(f'slot {slot} block {i} < shared_blocks={shared} '
                        f'but page {page} is not sealed')
                if i >= shared and page in self.sealed:
                    bad(f'slot {slot} block {i} >= shared_blocks={shared} '
                        f'points at SEALED page {page} (a private block '
                        f'must never alias an immutable page)')
            for i in range(held, self.max_blocks):
                if int(self.tables[slot, i]) != GARBAGE_PAGE:
                    bad(f'slot {slot} block {i} beyond counts={held} is '
                        f'{int(self.tables[slot, i])}, not the garbage '
                        f'page')
        for page in range(1, self.num_pages):
            want = ref_count.get(page, 0)
            if int(self.refs[page]) != want:
                bad(f'page {page} refcount {int(self.refs[page])} != '
                    f'{want} table references')
        for name, pages in (('free', self._free),
                            ('reserved', self.reserved),
                            ('evictable', list(self._evictable))):
            seen = set()
            for page in pages:
                if not 1 <= page < self.num_pages:
                    bad(f'{name} list holds page {page} (garbage page or '
                        f'out of range)')
                if page in seen:
                    bad(f'{name} list holds page {page} twice')
                if page in owned:
                    bad(f'page {page} is both {name} and owned by '
                        f'slot/block {owned[page]}')
                seen.add(page)
        free_set = set(self._free)
        evict_set = set(self._evictable)
        for a, b_ in (('free', 'reserved'), ('free', 'evictable'),
                      ('reserved', 'evictable')):
            sa = dict(free=free_set, reserved=set(self.reserved),
                      evictable=evict_set)
            inter = sa[a] & sa[b_]
            if inter:
                bad(f'pages {sorted(inter)} are both {a} and {b_}')
        for page in free_set | set(self.reserved):
            if page in self.sealed:
                bad(f'page {page} is free/reserved but still sealed')
            if int(self.refs[page]) != 0:
                bad(f'free/reserved page {page} has refcount '
                    f'{int(self.refs[page])}')
        for page in evict_set:
            if page not in self.sealed:
                bad(f'evictable page {page} is not sealed')
            if int(self.refs[page]) != 0:
                bad(f'evictable page {page} has refcount '
                    f'{int(self.refs[page])}')
            if page not in self._page_key:
                bad(f'evictable page {page} has no prefix entry (retired '
                    f'pages must free, not park)')
        for key, page in self._prefix.items():
            if self._page_key.get(page) != key:
                bad(f'prefix table not a bijection at page {page}')
            if page not in self.sealed:
                bad(f'prefix table points at unsealed page {page}')
        if len(self._page_key) != len(self._prefix):
            bad(f'{len(self._prefix)} prefix keys vs '
                f'{len(self._page_key)} page keys')
        for page in self.sealed:
            if int(self.refs[page]) == 0 and page not in evict_set:
                bad(f'sealed page {page} has refcount 0 but is not '
                    f'evictable')
        accounted = (len(self._free) + len(self.reserved)
                     + len(evict_set) + len(owned))
        if accounted != self.num_pages - 1:
            bad(f'{len(self._free)} free + {len(self.reserved)} reserved '
                f'+ {len(evict_set)} cached + {len(owned)} owned = '
                f'{accounted}, pool has {self.num_pages - 1} allocatable '
                f'pages')


# ----------------------------------------------------------------------------
# pure pool ops (in place)
# ----------------------------------------------------------------------------
def paged_token_update(pool: torch.Tensor, t: torch.Tensor, pos: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Write one decode-step slab ``t`` (B, 1, ...) into ``pool``
    (P, page_size, ...) at per-request positions ``pos`` (B,), following
    ``block_tables`` (B, W). Slots whose rows are all garbage write into
    page 0 (masked on read). In place; returns ``pool``."""
    ps = pool.shape[1]
    pos = pos.reshape(-1).to(torch.int64)
    page = block_tables.to(torch.int64).gather(1, (pos // ps)[:, None])[:, 0]
    pool[page, pos % ps] = t[:, 0].to(pool.dtype)
    return pool


def paged_prefill_update(pool: torch.Tensor, t: torch.Tensor,
                         block_tables: torch.Tensor) -> torch.Tensor:
    """Write a whole prompt's rows ``t`` (B, Sp, ...): row l of request b
    goes to page ``block_tables[b, l // page_size]``. In place."""
    b, sp = t.shape[:2]
    ps = pool.shape[1]
    if sp > block_tables.shape[1] * ps:
        raise ValueError(
            f'prompt length {sp} exceeds the block-table capacity '
            f'({block_tables.shape[1]} blocks * {ps} positions); size '
            f'max_blocks to the longest admissible sequence')
    l = torch.arange(sp, device=pool.device)
    page = block_tables.to(torch.int64)[:, l // ps]           # (B, Sp)
    row = (l % ps).expand(b, sp)
    pool[page.reshape(-1), row.reshape(-1)] = \
        t.reshape(b * sp, *t.shape[2:]).to(pool.dtype)
    return pool


def paged_chunk_update(pool: torch.Tensor, t: torch.Tensor, offset, limit,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Write a prefill CHUNK's rows ``t`` (B, C, ...): row i of request b
    holds absolute position ``offset[b] + i``; ``offset``/``limit`` are
    scalars or (B,). Rows at or beyond ``limit[b]`` (the chunk's padded
    tail) and rows past the table capacity go to the garbage page, so
    padding never lands in an owned (possibly shared) page. In place."""
    b, c = t.shape[:2]
    ps = pool.shape[1]
    w = block_tables.shape[1]
    dev = pool.device
    off = torch.as_tensor(offset, dtype=torch.int64,
                          device=dev).reshape(-1).expand(b)
    lim = torch.as_tensor(limit, dtype=torch.int64,
                          device=dev).reshape(-1).expand(b)
    posl = off[:, None] + torch.arange(c, device=dev)[None, :]   # (B, C)
    ok = (posl < lim[:, None]) & (posl < w * ps)
    blk = torch.clamp_max(posl // ps, w - 1)
    page = block_tables.to(torch.int64).gather(1, blk)
    page = torch.where(ok, page, GARBAGE_PAGE)
    pool[page.reshape(-1), (posl % ps).reshape(-1)] = \
        t.reshape(b * c, *t.shape[2:]).to(pool.dtype)
    return pool


def gather_pages(pool: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Densify: (P, page_size, ...) -> (B, W * page_size, ...) where logical
    position l of request b sits at [b, l] (the einsum-oracle view)."""
    g = pool[block_tables.to(torch.int64)]      # (B, W, page_size, ...)
    return g.reshape(block_tables.shape[0], -1, *pool.shape[2:])


def scatter_pages(pool: torch.Tensor, dense: torch.Tensor,
                  block_tables: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`gather_pages`: write a contiguous (B, S, ...) view
    into the pool at the tables' pages. S must be a multiple of page_size
    and cover at most W blocks. In place."""
    b, s = dense.shape[:2]
    ps = pool.shape[1]
    if s % ps != 0:
        raise ValueError(
            f'dense view length {s} is not a multiple of the page size '
            f'({ps}); scatter_pages writes whole pages — pad the view to '
            f'a page boundary')
    if s // ps > block_tables.shape[1]:
        raise ValueError(
            f'dense view length {s} spans {s // ps} blocks, exceeding the '
            f'block-table capacity ({block_tables.shape[1]} blocks * {ps} '
            f'positions); size max_blocks to the longest admissible '
            f'sequence')
    nb = s // ps
    blocks = dense.reshape(b * nb, ps, *dense.shape[2:])
    pool[block_tables[:, :nb].reshape(-1).to(torch.int64)] = \
        blocks.to(pool.dtype)
    return pool


def with_block_tables(cache_tree, tables):
    """Refresh every paged layout's block-table leaves (kept here as the
    public name the scheduler uses; the layout registry does the walk)."""
    from repro_torch.runtime import layouts
    return layouts.with_block_tables(cache_tree, tables)
