"""Tensor-parallel continuous serving of the port against its own one-device
serve: ``serve_continuous_group(runs, tp=2, device='cpu')`` serves every
run below on one spawned group of two gloo ranks, and each run must give
the tokens (and the events, preemptions, faults and terminal accounting)
of the same run at tp = 1, the reference's contract (its own tp = 2 equals
its tp = 1, tests/test_distributed_serve.py). Modes: bf16, the prefix
cache with chunked prefill, a squeezed pool that preempts, sampling, w8a8
with and without --prequantize, qat, seeded chaos over the int8 tier and
the prefix cache with metrics; families: GQA and MLA + MoE (deepseek-v3's
smoke config, over its int8 latent tier). The group's ranks run one
torch thread each: six test workers already load the host's cores.
analog_sim is per shard in the reference
too (its noise and TDC scale read each rank's columns), so two tp = 2
serves at one noise seed must agree with each other, not with tp = 1.

Structure: each serving step makes exactly one ``heads_all_gather`` per
attention layer (prefill, chunk and decode alike) and no other
collective, counted by ``distributed/collectives.py`` on every rank (the
port of test_tp_decode_one_collective_per_layer). The group's
``compressed_psum`` is held to the reference's on a 2-device mesh with
the same shards (tests/test_distributed_collectives.py)."""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import compat
from repro.distributed import collectives as rcoll
from repro_torch import configs as tconfigs
from repro_torch.distributed import ranks
from repro_torch.launch import serve as tserve
from repro_torch.runtime import faults as tfaults

GQA, MLA = 'stablelm-1.6b', 'deepseek-v3-671b'
KW = dict(slots=2, n_requests=3, prompt_len=16, gen_len=8, page_size=4,
          attn_impl='flash', quiet=True, metrics=False)


def _chaos_stream():
    rng = np.random.RandomState(11)
    return [tserve.Request(rid=i, prompt=rng.randint(
                0, 256, 6 + (i * 5) % 11).astype(np.int32),
                target_gen=3 + (i * 3) % 6) for i in range(7)]


def _injector():
    return tfaults.FaultInjector(0, tfaults.chaos_profile())


# name -> (arch, overrides of KW); each is served at tp = 1 and tp = 2
# (qwen2-moe's biased q/k/v are sliced in tests/test_torch_tp_specs.py;
# the int8 GQA tier and the metrics serve in the chaos run)
RUNS = {
    'bf16': (GQA, {}),
    'preempt': (GQA, dict(slots=3, num_pages=9, n_requests=5)),
    'prefix-chunk': (GQA, dict(prefix_cache=True, shared_prefix=8,
                               chunk_prefill=4)),
    'sampled': (GQA, dict(attn_impl='einsum', greedy=False,
                          temperature=0.8, top_k=5)),
    'w8a8-prequant': (GQA, dict(mode='w8a8', prequantize=True)),
    'w8a8-dynamic': (GQA, dict(mode='w8a8')),
    'qat': (GQA, dict(mode='qat')),
    'mla-moe': (MLA, dict(kv_quant=True, hot_window=1)),
}
ANALOG = dict(mode='analog_sim', noise_seed=3)


def _run(name):
    arch, over = RUNS[name]
    return dict(KW, arch=arch, **over)


# compressed_psum's shards: one random draw (the close-to-the-mean check)
# and the error-feedback case, a bias below one int8 step beside a value
# that sets the scale, equal on both shards, reduced 256 times
_RNG = np.random.RandomState(0)
PSUM_X = _RNG.randn(2, 4, 3).astype(np.float32)
EF_X = np.tile(np.array([[100.0, 0.01]], np.float32), (2, 1, 1))
EF_STEPS = 256


@contextlib.contextmanager
def one_thread_a_rank(tp):
    """The caller's torch threads cut to ``tp`` while a group runs, so
    each rank runs one (``ranks.run`` gives a rank 1/tp of them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(tp)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _psum_job(xs, steps):
    return ('repro_torch.distributed.collectives:psum_shards',
            dict(xs=xs, efs=np.zeros_like(xs), steps=steps))


@pytest.fixture(scope='module')
def served():
    """Every run at tp = 1 in this process, and at tp = 2 (the runs, the
    chaos run, two analog_sim runs at one noise seed, then the two
    compressed_psum cases) in one group."""
    one = {name: tserve.serve_continuous(device='cpu', **_run(name))
           for name in RUNS}
    one['chaos'] = tserve.serve_continuous(
        GQA, device='cpu', faults=_injector(), request_stream=_chaos_stream(),
        **dict(KW, kv_quant=True, hot_window=1, prefix_cache=True,
               metrics=True))
    runs = [_run(name) for name in RUNS]
    runs.append(dict(KW, arch=GQA, faults=_injector(),
                     request_stream=_chaos_stream(), kv_quant=True,
                     hot_window=1, prefix_cache=True, metrics=True))
    runs += [dict(KW, arch=GQA, **ANALOG)] * 2
    placed = ranks.placement(2, 'cpu')
    lead, rest = tserve.serve_jobs(runs, placed)
    psum = [_psum_job(PSUM_X, 1), _psum_job(EF_X, EF_STEPS)]
    with one_thread_a_rank(2):
        out = ranks.run(lead + psum, placed, worker_jobs=rest + psum)
    two = dict(zip(list(RUNS) + ['chaos', 'analog-a', 'analog-b', 'psum',
                                 'psum-ef'], out))
    return one, two


@pytest.mark.parametrize('name', list(RUNS))
def test_tp2_tokens_equal_tp1(served, name):
    one, two = served
    a, b = one[name], two[name]
    assert b['tp'] == 2 and b['backend'] == 'gloo'
    assert [r['device'] for r in b['ranks']] == ['cpu', 'cpu']
    assert b['completed'] == a['completed'] == a['requests']
    assert b['outputs'] == a['outputs']
    assert b['events'] == a['events']
    assert b['peak_pages'] == a['peak_pages']
    assert b['pages_quantized'] == a['pages_quantized']
    assert b['prefix'] == a['prefix']
    if name == 'preempt':
        assert a['preempted'] > 0
    if name == 'prefix-chunk':
        assert a['prefix']['hits'] >= 1 and a['chunk_prefill'] == 4
    if name == 'mla-moe':
        assert a['pages_quantized'] > 0


def test_tp2_telemetry_adds_only_the_per_shard_view(served):
    """The energy block (the chaos run's: the int8 tier, the prefix
    cache) equals one device's but for ``tp``, whose GQA aggregate equals
    the one-device columns bit for bit."""
    one, two = served
    e1 = dict(one['chaos']['telemetry']['energy'])
    e2 = dict(two['chaos']['telemetry']['energy'])
    view = e2.pop('tp')
    assert e2 == e1
    assert view['ways'] == 2 and not view['latent_replicated']
    for key, val in view['aggregate'].items():
        assert val == e1[key], key


def test_tp2_chaos_equals_tp1(served):
    one, two = served
    a, b = one['chaos'], two['chaos']
    assert len(a['faults']) >= 3
    assert b['faults'] == a['faults']
    assert b['terminal'] == a['terminal']
    assert b['outputs'] == a['outputs']
    assert [(e['kind'], e.get('rid')) for e in b['event_log']] == \
        [(e['kind'], e.get('rid')) for e in a['event_log']]
    assert b['quarantined'] == a['quarantined']


def test_tp2_analog_sim_is_per_shard_and_seeded(served):
    """Two tp = 2 serves at one noise seed give equal tokens: each rank's
    noise and TDC are drawn and scaled from its own columns, the same way
    in both (the per-shard epilogue itself is held to the reference in
    tests/test_torch_tp_specs.py)."""
    _, two = served
    assert two['analog-a']['completed'] == 3
    assert two['analog-a']['outputs'] == two['analog-b']['outputs']


def _forwards(out, run):
    """Forwards a serve ran: its decode steps, and per admission one
    prefill, or one a chunk where it took chunks (every admission with
    ``chunk_prefill``, prefix hits always)."""
    n_req, plen_pad = run['n_requests'], run['prompt_len']
    plen = {r.rid: len(r.prompt) for r in tserve._ragged_stream(
        n_req, plen_pad, run['gen_len'], np.zeros((n_req, plen_pad)))}
    c, n = out['chunk_prefill'], out['steps']
    for e in out['event_log']:
        if e['kind'] != 'admit':
            continue
        if c is not None and (run.get('chunk_prefill')
                              or e['prefill_start'] > 0):
            n += -(-(plen[e['rid']] - e['prefill_start']) // c)
        else:
            n += 1
    return n


@pytest.mark.parametrize('name', ['bf16', 'prefix-chunk', 'mla-moe'])
def test_one_heads_all_gather_per_attention_layer_per_step(served, name):
    """Every forward, a decode step, a monolithic prefill or a prefill
    chunk, makes one gather a layer; nothing else is a collective inside
    the steps, on either rank."""
    _, two = served
    out, run = two[name], _run(name)
    want = tconfigs.get(run['arch'], smoke=True).n_layers * \
        _forwards(out, run)
    assert out['collectives'] == dict(heads_all_gather=want, all_reduce=0,
                                      gather_objects=0)
    assert [r['collectives'] for r in out['ranks']] == \
        [out['collectives']] * 2


# ----------------------------------------------------------------------------
# compressed_psum over the group against the reference's over a mesh
# ----------------------------------------------------------------------------
def _mesh2():
    if jax.device_count() < 2:
        pytest.skip(f'needs 2 host devices, has {jax.device_count()}')
    return Mesh(np.asarray(jax.devices()[:2]), ('data',))


@functools.lru_cache(maxsize=None)
def _ref_psum():
    mesh = _mesh2()
    return jax.jit(compat.shard_map(
        lambda x, e: rcoll.compressed_psum(x, 'data', e), mesh=mesh,
        in_specs=(P('data'), P('data')), out_specs=(P('data'), P('data')),
        check_vma=False))


def test_compressed_psum_equals_reference_on_the_same_shards(served):
    """Mean and error feedback of each rank bit-equal to the reference's
    jitted shard_map on the same two shards (its mean comes back per
    shard here, so both shards' copies are compared)."""
    got = served[1]['psum']
    x = PSUM_X.reshape(8, 3)
    mean, ef = _ref_psum()(x, np.zeros_like(x))
    mean, ef = np.asarray(mean).reshape(2, 4, 3), \
        np.asarray(ef).reshape(2, 4, 3)
    twice, _ = _ref_psum()(2 * x, np.zeros_like(x))
    twice = np.asarray(twice).reshape(2, 4, 3)
    for r, (means, ef_r, plain, (tree_a, tree_c)) in enumerate(got):
        np.testing.assert_array_equal(means[0], mean[r])
        np.testing.assert_array_equal(ef_r, ef[r])
        np.testing.assert_allclose(plain, PSUM_X.mean(axis=0), rtol=1e-6)
        # tree_compressed_psum: the same reduction leaf by leaf
        np.testing.assert_array_equal(tree_a, mean[r])
        np.testing.assert_array_equal(tree_c, twice[r])
    # the int8 bound of the reference's own test
    scale = np.abs(PSUM_X).max() / 127.0
    np.testing.assert_allclose(got[0][0][0], PSUM_X.mean(axis=0),
                               atol=scale)


def test_compressed_psum_error_feedback_compensates(served):
    """A bias below one int8 step crosses the wire through the error
    feedback: the running mean over 256 steps is within half a step over
    the steps of it (the reference's bound), and every step's mean equals
    the reference's fed the same feedback."""
    means, ef, _, _ = served[1]['psum-ef'][0]
    got = np.mean([m[0] for m in means], axis=0)
    bound = (100.0 / 127.0) / (2 * EF_STEPS)
    assert abs(got[1] - 0.01) <= bound * 1.01, (got, bound)
    np.testing.assert_allclose(got[0], 100.0, rtol=1e-3)
    f = _ref_psum()
    x = EF_X.reshape(2, 2)
    e = np.zeros_like(x)
    for step in (0, 1, 2):
        m, e = f(x, e)
        np.testing.assert_array_equal(means[step][0],
                                      np.asarray(m).reshape(2, 2)[0])
