"""The port's fault injector, poison walker and allocator views against the
reference's (``repro.runtime.faults``, ``repro.runtime.layouts``), with no
model involved.

* The injector's arming pattern, its queries and its picks, step by step
  for 200 steps, under three seeds and three profiles: the chaos profile,
  the inert default and an explicit schedule.
* Prompt mangling, scheduled (oversize and garbage) and rate-driven.
* ``poison_tree_pages`` then ``scrub_tree_pages`` on every paged layout,
  single and layer-stacked, equal to the reference's walkers on the same
  numpy trees: poison NaNs the fp pools only, the int8 tier is spared by
  poison and zeroed by scrub.
* ``PagedKVCache.occupancy`` and ``KVTierTracker.residency`` equal along a
  random walk."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.runtime import faults as rfaults
from repro.runtime import kv_cache as rkvc
from repro.runtime import kv_quant as rkvq
from repro.runtime import layouts as rlayouts
from repro_torch.launch import serve as tserve
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import kv_quant as tkvq
from repro_torch.runtime import layouts as tlayouts

SCHEDULE = [(3, 'pool_squeeze', 4), (3, 'cancel', None), (5, 'cancel', 2),
            (7, 'preempt_storm', 2), (8, 'poison_page', None),
            (11, 'poison_logits', None), (11, 'drop_quant', None),
            (13, 'pool_squeeze', None), (17, 'kernel_fault', None),
            (0, 'mangle_prompt', (1, 'garbage'))]


def _profile(mod, name):
    if name == 'chaos':
        return mod.chaos_profile(), ()
    if name == 'default':
        return mod.FaultProfile(), ()
    return mod.FaultProfile(preempt_storm=0.1), SCHEDULE


def _replay(mod, seed, name, steps=200):
    """Every query the serve loop makes, in its order, each step, plus a
    pick after each fault that picks."""
    profile, schedule = _profile(mod, name)
    inj = mod.FaultInjector(seed, profile, schedule=schedule)
    trace = []
    for step in range(steps):
        inj.begin_step(step)
        row = [inj.squeeze_pages(), inj.cancel_now(), inj.storm_count(),
               inj.poison_page_now(), inj.poison_logits_now(),
               inj.drop_quant_now(), inj.kernel_fault_now()]
        if row[1] is True or row[3] or row[4]:
            row.append(inj.pick(range(step % 7 + 1)))
        trace.append(row)
    return trace, dict(inj.counts)


@pytest.mark.parametrize('name', ['chaos', 'default', 'schedule'])
@pytest.mark.parametrize('seed', [0, 1, 7])
def test_injector_arming_matches_reference(seed, name):
    got, got_counts = _replay(tfaults, seed, name)
    want, want_counts = _replay(rfaults, seed, name)
    assert got == want
    assert got_counts == want_counts
    if name == 'chaos':
        assert sum(want_counts.values()) > 20      # the pattern is not inert


def test_injector_refuses_unknown_kinds_as_reference():
    for mod in (tfaults, rfaults):
        with pytest.raises(ValueError, match='unknown fault kind'):
            mod.FaultInjector(0, schedule=[(1, 'bogus', None)])


@pytest.mark.parametrize('schedule,rate', [
    ([(0, 'mangle_prompt', (1, 'oversize')),
      (0, 'mangle_prompt', (3, 'garbage')), (0, 'mangle_prompt', 4)], 0.0),
    ([], 0.5)])
def test_mangle_matches_reference(schedule, rate):
    """Scheduled modes (a bare rid means oversize) and rate-driven ones:
    the same requests mangled the same way, the same garbage position."""
    out = {}
    for smod, fmod in ((tserve, tfaults), (rserve, rfaults)):
        inj = fmod.FaultInjector(
            5, fmod.FaultProfile(mangle_prompt=rate), schedule=schedule)
        rng = np.random.RandomState(3)
        reqs = [smod.Request(rid=i, prompt=rng.randint(0, 256, 6 + i)
                             .astype(np.int32), target_gen=4)
                for i in range(8)]
        mangled = [inj.mangle(r, prompt_pad=12, vocab=256) for r in reqs]
        out[fmod] = ([np.asarray(m.prompt).tolist() for m in mangled],
                     [m is r for m, r in zip(mangled, reqs)],
                     dict(inj.counts))
    assert out[tfaults] == out[rfaults]
    prompts, same, counts = out[tfaults]
    assert counts['mangle_prompt'] == 3 if schedule else \
        counts['mangle_prompt'] > 0
    assert any(len(p) > 12 for p in prompts)             # oversize
    if schedule:
        assert max(prompts[3]) == 256 + 7                 # garbage id


def _tree(kind, stacked, rng):
    """A numpy cache node of each paged layout (5 pages of 2 rows)."""
    lead = (2,) if stacked else ()
    p, ps, hkv, dh, dk = 5, 2, 2, 4, 6

    def f(*s):
        return rng.standard_normal(lead + s).astype(np.float32)

    def i8(*s):
        return rng.integers(-127, 128, lead + s).astype(np.int8)
    bt = np.tile(np.arange(3, dtype=np.int32)[None], (3, 1))
    node = dict(bt=np.broadcast_to(bt, lead + bt.shape).copy())
    if kind in ('paged', 'paged_q8'):
        node.update(k=f(p, ps, hkv, dh), v=f(p, ps, hkv, dh))
    else:
        node.update(cl=f(p, ps, dk))
    if kind == 'paged_q8':
        node.update(kq=i8(p, ps, hkv, dh), vq=i8(p, ps, hkv, dh),
                    ks=f(p, hkv), vs=f(p, hkv),
                    hw=np.broadcast_to(np.array([1], np.int32),
                                       lead + (1,)).copy())
    if kind == 'mla_q8':
        node.update(clq=i8(p, ps, dk), cs=f(p, 1),
                    hw=np.broadcast_to(np.array([1], np.int32),
                                       lead + (1,)).copy())
    return dict(layers=node)


@pytest.mark.parametrize('stacked', [False, True])
@pytest.mark.parametrize('kind', ['paged', 'paged_q8', 'mla', 'mla_q8'])
def test_poison_scrub_round_trip_matches_reference(kind, stacked):
    tree = _tree(kind, stacked, np.random.default_rng(0))
    ref = {k: jnp.asarray(v) for k, v in tree['layers'].items()}
    got = {k: torch.from_numpy(v.copy()) for k, v in tree['layers'].items()}
    lay = tlayouts.get_layout(got)
    assert lay.name == rlayouts.get_layout(ref).name
    ref = rlayouts.poison_tree_pages(dict(layers=ref), jnp.asarray([1, 3]))
    got = tlayouts.poison_tree_pages(dict(layers=got), [1, 3])
    for key, leaf in got['layers'].items():
        want = np.asarray(ref['layers'][key])
        np.testing.assert_array_equal(leaf.numpy(), want)   # NaN == NaN
        poisoned = np.isnan(leaf.numpy()) if leaf.is_floating_point() \
            else np.zeros(leaf.shape, bool)
        assert poisoned.any() == (key in lay.poison_leaves), key
        if key in lay.poison_leaves:
            pages = poisoned[:, [1, 3]] if stacked else poisoned[[1, 3]]
            assert pages.all()
            assert poisoned.sum() == pages.size
    ref = rlayouts.scrub_tree_pages(ref, jnp.asarray([1, 3]))
    got = tlayouts.scrub_tree_pages(got, [1, 3])
    for key, leaf in got['layers'].items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(ref['layers'][key]))
        assert not np.isnan(leaf.numpy().astype(np.float64)).any()
        if key in lay.scrub_leaves:
            pages = leaf[:, [1, 3]] if stacked else leaf[[1, 3]]
            assert not pages.any(), key                  # int8 tier too


@pytest.mark.parametrize('seed', [0, 3])
def test_occupancy_and_residency_match_reference(seed):
    rng = np.random.RandomState(seed)
    kvs = [m.PagedKVCache(num_pages=12, page_size=4, max_blocks=5, slots=3,
                          prefix_cache=True) for m in (rkvc, tkvc)]
    tiers = [rkvq.KVTierTracker(1, 4), tkvq.KVTierTracker(1, 4)]
    for _ in range(200):
        op, s = rng.randint(5), rng.randint(3)
        pos = rng.randint(20)
        prompt = rng.randint(0, 3, 4 * rng.randint(1, 4)).astype(np.int32)
        n = rng.randint(1, 4)
        for kv, tier in zip(kvs, tiers):
            if op == 0 and int(kv.counts[s]) == 0:
                if kv.admit_prompt(s, prompt) is not None:
                    kv.seal_slot(s, prompt)
            elif op == 1:
                if kv.ensure(s, pos):
                    tier.aged_out(s, pos, kv.tables[s])
            elif op == 2:
                kv.release(s)
                tier.reset(s)
            elif op == 3:
                kv.reserve_pages(n)
            else:
                kv.unreserve_pages(n)
            kv.check_invariants()
        assert kvs[1].occupancy() == kvs[0].occupancy()
        assert tiers[1].residency() == tiers[0].residency()
        assert [tiers[1].cold_blocks(i) for i in range(3)] == \
            [tiers[0].cold_blocks(i) for i in range(3)]
