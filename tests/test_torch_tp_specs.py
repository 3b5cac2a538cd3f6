"""The head-parallel serving layout of the port against the reference's,
with no process started: ``distributed/sharding.py``'s parameter slices
and refusals, a rank's own draw and pool part (``rank_transform``,
``init_paged_cache_tree(tp=)``), the energy
meter's per-shard view, analog_sim's per-shard epilogue, the per-rank
memory reckoning, the key-split plans under TP and the CLI's ``--tp``.

Tolerances: every slice, refusal and meter total equal (the meter's GQA
aggregate bit for bit, the reference's own test); analog_sim's epilogue
on a rank's columns equal to the reference's ``linear`` on the same
column slice with JAX's normals patched in, within the bound of
tests/test_torch_fidelity_linear.py::assert_analog_equal (equal TDC codes,
values within 2 ulps of the full scale: where XLA contracts the
share-line gain into the noise add, the TDC scale can move one ulp; at
these shapes it does for some draws and not others, at tp = 1 as on a
rank's 256 columns)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.distributed import sharding as rsharding
from repro.models import model as rmodel
from repro.runtime import layouts as rlayouts
from repro.runtime.telemetry import EnergyMeter as REnergyMeter
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels import flash_decode as tfd
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.runtime.telemetry import EnergyMeter as TEnergyMeter
from test_torch_fidelity_linear import _xw, assert_analog_equal, jax_normals
from test_torch_latent_chunk import _launches

GQA, MLA, MOE = 'stablelm-1.6b', 'deepseek-v3-671b', 'qwen2-moe-a2.7b'


def _ref_tree(arch):
    """A tree in the reference's form (numpy, layer-stacked): the port's
    seeded draw through ``params_to_numpy`` (the values do not matter
    here, and the reference's eager draw of deepseek-v3 takes 12 s)."""
    cfg = tconfigs.get(arch, smoke=True)
    return tmodel.params_to_numpy(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg, device='cpu'), cfg)


def _slice_by_specs(tree, specs, rank, tp):
    """The reference's tree cut as its specs name it: rank ``rank``'s 1/tp
    of each dim marked 'model' (numpy)."""
    def cut(leaf, spec):
        leaf = np.asarray(leaf)
        for dim, axis in enumerate(spec):
            if axis == 'model':
                per = leaf.shape[dim] // tp
                leaf = np.take(leaf, range(rank * per, (rank + 1) * per),
                               axis=dim)
        return leaf
    return jax.tree.map(cut, tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def _assert_same_tree(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f'{path}/{i}')
    elif isinstance(want, tuple):                 # QuantizedWeight
        assert type(got) is type(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f'{path}.{i}')
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.stride() == want.stride(), (path, got.stride(),
                                               want.stride())
        assert torch.equal(got, want), path


# (arch, serving mode, prequantized): bf16 leaves (K, N); deepseek-v3's
# MLA and MoE layers as dynamic-mode K-major f32 masters; qwen2-moe's
# biased q/k/v; stablelm's int8 codes (K-major) and (1, N) scales
PARAM_CASES = [(GQA, 'bf16', False, 2), (GQA, 'bf16', False, 4),
               (MLA, 'w8a8', False, 2), (MOE, 'bf16', False, 2),
               (GQA, 'w8a8', True, 2)]


@pytest.mark.parametrize('arch,mode,prequant,tp', PARAM_CASES,
                         ids=[f'{a}-{m}{"-prequant" if p else ""}-tp{t}'
                              for a, m, p, t in PARAM_CASES])
def test_shard_serve_params_equals_reference_spec_slices(arch, mode,
                                                         prequant, tp):
    cfg = tconfigs.get(arch, smoke=True)
    ref = _ref_tree(arch)
    if prequant:
        ref = ryl.quantize_tree(jax.tree.map(jnp.asarray, ref))
    specs = rsharding.serve_tp_param_specs(ref)
    ref_np = jax.tree.map(np.asarray, ref)
    whole = tmodel.serving_form(tmodel.params_from_numpy(ref_np, cfg, 'cpu'),
                                mode, prequant, torch.bfloat16)
    for rank in range(tp):
        want = tmodel.serving_form(
            tmodel.params_from_numpy(
                _slice_by_specs(ref_np, specs, rank, tp), cfg, 'cpu'),
            mode, prequant, torch.bfloat16)
        got = tsharding.shard_serve_params(whole, rank, tp)
        _assert_same_tree(_pop_uv_ways(got, want, rank, tp), want)
    # the replicated leaves are the whole tree's, uncopied
    attn = tsharding.shard_serve_params(whole, 1, tp)
    layer = attn['layers'][0]['attn']
    assert layer['wo'] is whole['layers'][0]['attn']['wo']
    assert attn['embed'] is whole['embed']


def _pop_uv_ways(got, want, rank, tp):
    """``got`` without the ``w_ukv_ways`` leaves a rank's MLA layers
    carry beside ``w_ukv``, each checked first: the rank's ``w_ukv``
    columns of ``want`` in their place among zeros at the whole width,
    f32, row-major."""
    if isinstance(got, dict):
        out = {}
        for k, v in got.items():
            if k == tattention.TP_UV_KEY:
                w = want['w_ukv']
                n = w.shape[-1]
                assert v.dtype == torch.float32 and v.is_contiguous()
                assert v.shape == (w.shape[0], n * tp)
                assert torch.equal(v[:, rank * n:(rank + 1) * n],
                                   w.to(torch.float32))
                assert not v[:, :rank * n].any()
                assert not v[:, (rank + 1) * n:].any()
                continue
            out[k] = _pop_uv_ways(v, want[k], rank, tp)
        return out
    if isinstance(got, list):
        return [_pop_uv_ways(g, w, rank, tp) for g, w in zip(got, want)]
    return got


@pytest.mark.parametrize('arch,mode,prequant,tp', PARAM_CASES,
                         ids=[f'{a}-{m}{"-prequant" if p else ""}-tp{t}'
                              for a, m, p, t in PARAM_CASES])
def test_rank_draw_equals_the_whole_draws_cut(arch, mode, prequant, tp):
    """A rank's own seeded draw (``rank_transform``, each head projection
    cut as it is drawn, then the biases and MLA's whole-count W_uv) equals
    the whole draw cut by ``shard_serve_params``, leaf for leaf."""
    cfg = tconfigs.get(arch, smoke=True)
    serving = tmodel.serving_transform(mode, prequant, torch.bfloat16)
    whole = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device='cpu', transform=serving)
    for rank in range(tp):
        drawn = tmodel.init_params(
            torch.Generator().manual_seed(0), cfg, device='cpu',
            transform=tsharding.rank_transform(serving, rank, tp))
        _assert_same_tree(
            tsharding.shard_serve_params(drawn, rank, tp, drawn=True),
            tsharding.shard_serve_params(whole, rank, tp))


# every paged layout, the int8 tiers included, and the recurrent ones:
# (name, arch, tree kind)
CACHES = [(f'{arch}-{kind}', arch, kind)
          for arch in (GQA, MLA, 'mamba2-780m', 'zamba2-1.2b')
          for kind in ('fp', 'int8')
          if not (arch == 'mamba2-780m' and kind == 'int8')]


@pytest.mark.parametrize('name,arch,kind', CACHES,
                         ids=[name for name, _, _ in CACHES])
def test_rank_pool_equals_reference_tree_shard_specs(name, arch, kind):
    """A rank's pool part as allocated (``init_paged_cache_tree(tp=2)``)
    equals the reference's paged tree cut by ``tree_shard_specs``: every
    leaf's shape, dtype and values, the broadcast leaves broadcast."""
    sizes = dict(num_pages=9, page_size=4, max_blocks=4, hot_window=2,
                 kv_dtype='int8' if kind == 'int8' else None)
    tree = jax.tree.map(np.asarray, rmodel.init_paged_cache_tree(
        rconfigs.get(arch, smoke=True), 2, dtype=jnp.float32, **sizes))
    specs = rlayouts.tree_shard_specs(jax.tree.map(jnp.asarray, tree))
    # GQA pools split, zamba2's attention sites included; MLA latent
    # pools and recurrent state do not
    sharded = any(ax == 'model' for spec in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P)) for ax in spec)
    assert sharded == name.startswith((GQA, 'zamba2'))
    got = tmodel.cache_to_numpy(tmodel.init_paged_cache_tree(
        tconfigs.get(arch, smoke=True), 2, dtype=torch.float32,
        device='cpu', tp=2, **sizes))
    for rank in range(2):
        want = _slice_by_specs(tree, specs, rank, 2)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_rank_pool_keeps_broadcast_leaves_and_own_pools():
    cfg = tconfigs.get(GQA, smoke=True)
    part = tmodel.init_paged_cache_tree(cfg, 2, num_pages=9, page_size=4,
                                        max_blocks=4, kv_dtype='int8',
                                        device='cpu', tp=2)['layers']
    assert part['bt'].stride()[0] == 0 and part['hw'].stride()[0] == 0
    assert part['k'].shape[-2] == cfg.n_kv_heads // 2
    assert part['ks'].shape[-1] == cfg.n_kv_heads // 2
    assert part['k'].is_contiguous()
    assert part['k'].data_ptr() != part['v'].data_ptr()


def _outcome(fn, *args):
    try:
        fn(*args)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def test_validate_serve_tp_accepts_and_refuses_as_the_reference():
    for arch in tconfigs.names():
        for smoke in (True, False):
            for tp in (0, 1, 2, 3, 4, 8, 16):
                want = _outcome(rsharding.validate_serve_tp,
                                rconfigs.get(arch, smoke=smoke), tp)
                got = _outcome(tsharding.validate_serve_tp,
                               tconfigs.get(arch, smoke=smoke), tp)
                assert got == want, (arch, smoke, tp)


def test_serve_continuous_refuses_before_any_spawn():
    """The reference's refusals at the entry point, raised in the caller."""
    with pytest.raises(NotImplementedError, match='recurrent'):
        tserve.serve_continuous('mamba2-780m', tp=2, device='cpu')
    with pytest.raises(ValueError, match='n_heads'):
        tserve.serve_continuous(GQA, tp=3, device='cpu')
    with pytest.raises(ValueError, match='n_kv_heads'):
        tserve.serve_continuous('gemma3-27b', tp=4, device='cpu')
    with pytest.raises(ValueError, match='tp must be'):
        tserve.serve_continuous(GQA, tp=0, device='cpu')


# ----------------------------------------------------------------------------
# EnergyMeter: the reference's per-shard tests, and equal totals
# ----------------------------------------------------------------------------
_LANES = [[(9, 0), (17, 2)], [(10, 1), (18, 2)], [(11, 1)]]
_AGG_KEYS = ('hot_bytes', 'cold_bytes', 'achieved_bytes', 'baseline_bytes',
             'achieved_pj', 'baseline_pj', 'ops')


def _meter(meter_cls, cfgs, arch, tp):
    m = meter_cls(cfgs.get(arch, smoke=True), page_size=4, kv_quant=True,
                  hot_window=1, tp=tp)
    for lanes in _LANES:
        m.observe_step(lanes)
    return m.totals()


@pytest.mark.parametrize('arch,tp', [(GQA, 2), (GQA, 4), (MLA, 2)])
def test_energy_meter_totals_equal_reference(arch, tp):
    assert _meter(TEnergyMeter, tconfigs, arch, tp) == \
        _meter(REnergyMeter, rconfigs, arch, tp)


def test_energy_meter_per_shard_gqa_exact():
    single = _meter(TEnergyMeter, tconfigs, GQA, 1)
    assert 'tp' not in single
    for ways in (2, 4):
        t = _meter(TEnergyMeter, tconfigs, GQA, ways)
        for k in _AGG_KEYS:
            assert t[k] == single[k], k
        d = t['tp']
        assert d['ways'] == ways and not d['latent_replicated']
        for k in _AGG_KEYS:
            assert d['per_shard'][k] == single[k] / ways, k
            assert d['aggregate'][k] == single[k], k
        assert d['redundant_bytes'] == 0.0


def test_energy_meter_per_shard_mla_replicated():
    single = _meter(TEnergyMeter, tconfigs, MLA, 1)
    d = _meter(TEnergyMeter, tconfigs, MLA, 2)['tp']
    assert d['latent_replicated']
    for k in _AGG_KEYS[:-1]:
        assert d['per_shard'][k] == single[k], k
        assert d['aggregate'][k] == single[k], k
    assert d['per_shard']['ops'] == single['ops'] / 2
    assert d['aggregate']['ops'] == single['ops']
    assert d['redundant_bytes'] == single['achieved_bytes']


# ----------------------------------------------------------------------------
# analog_sim on a rank's columns
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('prequant', [False, True])
def test_analog_sim_shard_equals_reference_on_the_column_slice(
        monkeypatch, prequant):
    """Each rank's epilogue reads its own columns: the full scale, the TDC
    absmax and the noise key (K * 131 + N/tp) of its slice, as the
    reference computes inside its shard_map. A rank's output equals the
    reference's linear on the same column slice, and is not the slice of
    the one-device output."""
    monkeypatch.setattr(tyl, 'analog_normals', jax_normals)
    x, w = _xw((8, 1), 2048, 512, seed=9)
    cfg = tyl.YocoConfig(mode='analog_sim', compute_dtype=torch.float32)
    rcfg = ryl.YocoConfig(mode='analog_sim', compute_dtype=jnp.float32)
    tw = tyl.prequantize_weight(torch.from_numpy(w)) if prequant else \
        tyl.k_major(torch.from_numpy(w))
    whole = tyl.linear(torch.from_numpy(x), tw, cfg=cfg).numpy()
    for rank in range(2):
        part = tsharding.shard_serve_params(dict(wq=tw), rank, 2)['wq']
        got = tyl.linear(torch.from_numpy(x), part, cfg=cfg).numpy()
        cols = w[:, rank * 256:(rank + 1) * 256]
        rw = ryl.prequantize_weight(jnp.asarray(cols)) if prequant \
            else jnp.asarray(cols)
        want = np.asarray(jax.jit(lambda a, b: ryl.linear(a, b, cfg=rcfg))(
            jnp.asarray(x), rw))
        assert_analog_equal(got, want, exact=False)
        assert not np.array_equal(got, whole[..., rank * 256:
                                             (rank + 1) * 256])


def test_uv_product_under_tp_is_the_whole_products_slice():
    """MLA's W_uv product on a rank's heads, computed at the whole head
    count (``attention._uv_product``; on the card cuBLAS sums a batched
    product over fewer heads otherwise, ROADMAP Queue 3), equals the slice
    of the one-device product, at a decode step's and a chunk's rows."""
    import types

    m = types.SimpleNamespace(nope_head_dim=4, v_head_dim=6, kv_lora_rank=8)

    def uv(o, p, rt):
        return tattention._uv_product(
            o, tattention._absorb_weights(p, m)[1], p, m, rt)
    gen = torch.Generator().manual_seed(0)
    w_ukv = torch.randn((8, 8 * 10), generator=gen)
    for shape in ((3, 1), (1, 5)):
        o_lat = torch.randn(shape + (8, 8), generator=gen)
        whole = uv(o_lat, dict(w_ukv=w_ukv), None)
        for tp in (2, 4):
            for rank in range(tp):
                group = types.SimpleNamespace(size=lambda tp=tp: tp,
                                              rank=lambda rank=rank: rank)
                heads = slice(rank * 8 // tp, (rank + 1) * 8 // tp)
                part = tsharding.shard_serve_params(dict(w_ukv=w_ukv),
                                                    rank, tp)
                assert set(part) == {'w_ukv', tattention.TP_UV_KEY}
                got = uv(o_lat[:, :, heads].contiguous(), part,
                         types.SimpleNamespace(tp_group=group))
                assert torch.equal(got, whole[:, :, heads])


# ----------------------------------------------------------------------------
# per-rank memory, plans, CLI
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('arch,mode,prequant', [(GQA, 'bf16', False),
                                                (GQA, 'w8a8', True),
                                                (MLA, 'w8a8', False)])
def test_serving_and_pool_bytes_are_a_rank_part(arch, mode, prequant):
    cfg = tconfigs.get(arch, smoke=True)
    params = tmodel.init_params(
        torch.Generator().manual_seed(0), cfg, device='cpu',
        transform=tmodel.serving_transform(mode, prequant, torch.bfloat16))
    pool = dict(batch=2, num_pages=9, page_size=4, max_blocks=4,
                kv_dtype='int8')
    for tp in (1, 2):
        assert tsharding.serving_bytes(cfg, mode, prequant, torch.bfloat16,
                                       tp) == tsharding.nbytes(
            tsharding.shard_serve_params(params, 0, tp))
        assert tsharding.pool_bytes(cfg, tp, **pool) == tsharding.nbytes(
            tmodel.init_paged_cache_tree(cfg, device='cpu', tp=tp, **pool))
    assert tsharding.pool_bytes(cfg, 2, **pool) \
        < tsharding.pool_bytes(cfg, 1, **pool) or cfg.mla is not None
    assert tsharding.serving_bytes(cfg, mode, prequant, torch.bfloat16, 2) \
        < tsharding.serving_bytes(cfg, mode, prequant, torch.bfloat16, 1)


def test_oversize_reckons_every_rank_on_a_card(monkeypatch):
    """Four ranks on one card need four ranks' bytes free: refused with
    less, before any draw (the card's memory stubbed)."""
    cfg = tconfigs.get(GQA, smoke=True)
    pool = dict(batch=2, num_pages=9, page_size=4, max_blocks=4,
                kv_dtype=None, hot_window=2)
    per = (tsharding.serving_bytes(cfg, 'bf16', False, torch.bfloat16, 4)
           + tsharding.pool_bytes(cfg, 4, dtype=torch.bfloat16, **pool))
    devs = [torch.device('cuda', 0)] * 4
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda dev: (4 * per - 1, 8 * per))
    with pytest.raises(ValueError, match='4 ranks on cuda:0'):
        tserve._refuse_oversize_tp(cfg, devs, 'bf16', False, torch.bfloat16,
                                   pool)
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda dev: (4 * per, 8 * per))
    tserve._refuse_oversize_tp(cfg, devs, 'bf16', False, torch.bfloat16,
                               pool)


def _contains(args, seq) -> bool:
    seq = tuple(seq)
    return any(tuple(args[i:i + len(seq)]) == seq
               for i in range(len(args) - len(seq) + 1))


@pytest.mark.parametrize('kernel', ['k1', 'k6', 'k5', 'k8', 'k10', 'k9'])
def test_tp_plans_cut_keys_for_the_whole_head_count(monkeypatch, kernel):
    """Under TP (``ways``) a rank's launch carries the plan of all the
    heads, so each (request, head) is cut as at tp = 1 and its output is
    bit-equal to its slice of the one-device output: at B=8 and W=512
    pages of 8 (W=20, the serving row, for K9's 8-token chunk), the plan
    of a rank's own head count (stablelm's Hkv = 32 / 4 ranks,
    deepseek-v3's H = 128 / 4) would cut the keys otherwise. The
    wrappers' CUDA branch runs on meta tensors."""
    calls = _launches(monkeypatch)
    meta = dict(device='meta')
    b, ps, ways = 8, 8, 4
    w = 20 if kernel == 'k9' else 512
    i32 = dict(dtype=torch.int32, **meta)
    bt, pos = torch.empty((b, w), **i32), torch.empty((b,), **i32)
    if kernel in ('k1', 'k6', 'k5'):
        hkv, dh = 32 // ways, 64
        kp = torch.empty((1 + b * w, ps, hkv, dh), dtype=torch.bfloat16,
                         **meta)
        if kernel == 'k5':
            tfd.flash_chunk_paged(torch.empty((b, 8, hkv, dh), **meta), kp,
                                  kp, pos, pos, bt, scale=0.1, ways=ways)
            plan = [tfd.chunk_split_plan(b, w, ps, n, 8, 1, dh, 2)
                    for n in (hkv * ways, hkv)]
        else:
            q = torch.empty((b, 1, hkv, dh), **meta)
            if kernel == 'k1':
                tfd.flash_decode_paged(q, kp, kp, pos, bt, scale=0.1,
                                       ways=ways)
            else:
                kq = torch.empty(kp.shape, dtype=torch.int8, **meta)
                ks = torch.empty((1 + b * w, hkv), **meta)
                tfd.flash_decode_paged_q8(q, kp, kp, kq, kq, ks, ks, pos, bt,
                                          2, scale=0.1, ways=ways)
            plan = [tfd.paged_split_plan(b, w, ps, n, 1, dh, 2)
                    for n in (hkv * ways, hkv)]
        whole, mine = (tfd._plan_args(p) for p in plan)
    else:
        h, dk, r = 128 // ways, 576, 512
        cl = torch.empty((1 + b * w, ps, dk), dtype=torch.bfloat16, **meta)
        rows = h
        if kernel == 'k9':
            tfd.flash_chunk_paged_mla(torch.empty((b, 8, h, dk), **meta), cl,
                                      pos, pos, bt, r=r, scale=0.1,
                                      ways=ways)
            rows = 8 * h
        elif kernel == 'k8':
            tfd.flash_decode_paged_mla(torch.empty((b, 1, h, dk), **meta), cl,
                                       pos, bt, r=r, scale=0.1, ways=ways)
        else:
            cq = torch.empty(cl.shape, dtype=torch.int8, **meta)
            tfd.flash_decode_paged_mla_q8(
                torch.empty((b, 1, h, dk), **meta), cl, cq,
                torch.empty((1 + b * w, 1), **meta), pos, bt, 2, r=r,
                scale=0.1, ways=ways)
        whole, mine = (tfd._latent_plan_args(tfd.latent_split_plan(
            b, w, ps, n, dk, r, 2)) for n in (rows * ways, rows))
    (_, _, args), = calls
    assert whole != mine
    assert _contains(args, whole) and not _contains(args, mine)


def test_cli_tp_routes_to_the_group(monkeypatch):
    """``--continuous --tp N`` reaches the group with N ranks; ``--tp`` on
    the static path is refused."""
    seen = {}

    def group(runs, *, tp, device=None):
        seen.update(runs=runs, tp=tp, device=device)
        return [dict(outputs={})]
    monkeypatch.setattr(tserve, 'serve_continuous_group', group)
    tserve.main(['--continuous', '--tp', '2', '--device', 'cpu',
                 '--kv-quant', '--requests', '2'])
    assert seen['tp'] == 2 and seen['device'] == 'cpu'
    (run,) = seen['runs']
    assert run['kv_quant'] and run['n_requests'] == 2
    assert 'tp' not in run and 'device' not in run
    with pytest.raises(ValueError, match='--continuous'):
        tserve.main(['--tp', '2', '--device', 'cpu'])
