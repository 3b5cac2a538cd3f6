"""The port's ContinuousScheduler + PagedKVCache against the reference's,
with no model involved: the same request stream and a scripted token feed
must give the same event sequence (kind, step, rid, slot) and the same
block tables after every step, with ``check_invariants()`` green after
every step — including a pool small enough to force preemption — and the
allocator random walk of tests/test_kv_cache.py must give identical
tables on both."""

import numpy as np
import pytest

from repro.launch import serve as rserve
from repro.runtime import kv_cache as rkvc
from repro_torch.launch import serve as tserve
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import kv_cache as tkvc


def _stream(mod, n, seed=0, plen_max=16, gen_max=10):
    rng = np.random.RandomState(seed)
    return [mod.Request(rid=i,
                        prompt=rng.randint(0, 256, rng.randint(3, plen_max + 1)
                                           ).astype(np.int32),
                        target_gen=int(rng.randint(2, gen_max + 1)))
            for i in range(n)]


def _token(rid, n):
    return (rid * 7 + n * 3) % 50


def _drive(serve_mod, kvc_mod, *, num_pages, slots, stream, ps=4,
           prompt_pad=16, gen_max=10, eos_id=None, deadline=None,
           retry_budget=8, max_queue=None, cancels=None, storms=()):
    """The serve loop's host half, with tokens scripted from (rid, index);
    ``cancels`` (step -> rid) cancels as a step opens and ``storms`` (steps)
    force a preemption after admission, where the chaos loop does."""
    max_blocks = -(-(prompt_pad + gen_max) // ps)
    kv = kvc_mod.PagedKVCache(num_pages, ps, max_blocks, slots)
    sched = serve_mod.ContinuousScheduler(
        kv, prompt_pad=prompt_pad, eos_id=eos_id, retry_budget=retry_budget,
        max_queue=max_queue, vocab_size=256)
    for req in stream:
        req.ttl_steps = deadline
        sched.submit(req)
    tables = []
    step = 0
    while not sched.done and step < 500:
        sched.begin_step(step)
        if step in (cancels or {}):
            sched.cancel(cancels[step])
        for req, slot, _ in sched.try_admit():
            sched.seed(req, slot, _token(req.rid, 0))
        if sched.done:
            break
        if step in storms:
            assert sched.force_preempt()
        sched.grow_for_decode()
        toks = np.zeros((slots,), np.int32)
        for slot, st in sched.active.items():
            toks[slot] = _token(st.req.rid, len(st.tokens))
        sched.absorb(toks)
        kv.check_invariants()
        tables.append(kv.tables.copy())
        step += 1
    events = [(e.kind, e.step, e.rid, e.slot) for e in sched.events]
    outputs = {st.req.rid: st.tokens for st in sched.completed}
    return events, tables, outputs, sched.events.terminal_accounting()


CASES = {
    'roomy': dict(num_pages=1 + 3 * 7, slots=3),
    'preempting': dict(num_pages=1 + 9, slots=3),
    'minimal_pool': dict(num_pages=1 + 7, slots=2, retry_budget=2),
    'eos_and_deadline': dict(num_pages=1 + 10, slots=2, eos_id=13,
                             deadline=12),
    'backpressure': dict(num_pages=1 + 12, slots=2, max_queue=4),
    # chaos hooks: a pending and an active cancellation, preemption storms
    'cancel': dict(num_pages=1 + 3 * 7, slots=3, cancels={0: 9, 3: 4,
                                                          6: 0}),
    'storm': dict(num_pages=1 + 3 * 7, slots=3, storms=(1, 2, 5, 9)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_scheduler_matches_reference(case):
    kw = CASES[case]
    r = _drive(rserve, rkvc, stream=_stream(rserve, 10), **kw)
    t = _drive(tserve, tkvc, stream=_stream(tserve, 10), **kw)
    assert t[0] == r[0]                                   # event sequence
    assert len(t[1]) == len(r[1])
    for got, want in zip(t[1], r[1]):
        np.testing.assert_array_equal(got, want)          # tables per step
    assert t[2] == r[2] and t[3] == r[3]
    if case in ('preempting', 'storm'):
        assert any(e[0] == 'preempt' for e in t[0])
    if case == 'cancel':
        assert list(t[3].values()).count('cancel') == 3


@pytest.mark.parametrize('seed,num_pages,slots,max_blocks',
                         [(0, 9, 2, 4), (2, 6, 3, 8), (4, 5, 2, 3)])
def test_allocator_random_walk_matches_reference(seed, num_pages, slots,
                                                 max_blocks):
    rng = np.random.RandomState(seed)
    kvs = [m.PagedKVCache(num_pages=num_pages, page_size=4,
                          max_blocks=max_blocks, slots=slots)
           for m in (rkvc, tkvc)]
    for _ in range(300):
        op = rng.randint(5)
        s = rng.randint(slots)
        n = rng.randint(1, max_blocks + 1)
        pos = rng.randint(max_blocks * 4)
        res = rng.randint(1, num_pages)
        half = rng.rand() < 0.5
        outs = []
        for kv in kvs:
            if op == 0:
                outs.append(kv.alloc_blocks(s, n))
            elif op == 1:
                outs.append(kv.ensure(s, pos))
            elif op == 2:
                outs.append(kv.release(s))
            elif op == 3:
                outs.append(kv.reserve_pages(res))
            else:
                outs.append(kv.unreserve_pages(None if half else res))
            kv.check_invariants()
        assert outs[0] == outs[1]
        np.testing.assert_array_equal(kvs[1].tables, kvs[0].tables)
        assert kvs[1].free_pages == kvs[0].free_pages
        assert kvs[1].reserved == kvs[0].reserved


def test_check_invariants_catches_corruption():
    kv = tkvc.PagedKVCache(num_pages=6, page_size=4, max_blocks=3, slots=2)
    assert kv.alloc_blocks(0, 2)
    kv.check_invariants()
    kv.tables[1, 0] = kv.tables[0, 0]                     # aliasing
    kv.counts[1] = 1
    with pytest.raises(ValueError, match='owned twice'):
        kv.check_invariants()
    # the sharing allocator audits its refcounts too
    pc = tkvc.PagedKVCache(num_pages=6, page_size=4, max_blocks=3, slots=2,
                           prefix_cache=True)
    prompt = np.arange(1, 9, dtype=np.int32)
    assert pc.admit_prompt(0, prompt) is not None
    pc.seal_slot(0, prompt)
    pc.check_invariants()
    pc.refs[int(pc.tables[0, 0])] += 1
    with pytest.raises(ValueError, match='refcount'):
        pc.check_invariants()


def test_event_log_terminal_accounting_audits():
    log = tfaults.EventLog(clock=iter(range(100)).__next__)
    log.emit('submit', step=0, rid=1)
    with pytest.raises(ValueError, match='no terminal event'):
        log.terminal_accounting()
    log.emit('finish', step=1, rid=1)
    assert log.terminal_accounting() == {1: 'finish'}
    log.emit('evict', step=2, rid=1)
    with pytest.raises(ValueError, match='activity after'):
        log.terminal_accounting()
    with pytest.raises(ValueError, match='unknown event kind'):
        log.emit('bogus')
    ev = tfaults.EventLog()
    ev.emit('admit', step=0, rid=3, slot=1)
    ev.annotate_last('admit', 3, prefill_s=0.5)
    assert ev.records()[0]['prefill_s'] == 0.5 and ev.counts() == {'admit': 1}
