"""``core/roofline.py`` and the dry run's config facts against the
reference's, on the CPU.

* ``SHAPES``, ``cell_is_live``, ``param_count`` and ``active_param_count``
  equal the reference's for all 10 configs, 64 live cells over both
  meshes (``tests/test_dryrun_artifacts.py::test_expected_cell_count``).
* ``flops_for_cell`` (both remat settings), ``cache_bytes``,
  ``hbm_bytes_for_cell``, ``matmul_flops_per_token`` and
  ``attention_flops_per_token`` equal the reference's exactly in every
  cell: the analytic model is the reference's; only the constants are the
  H100's.
* The constants are the card's datasheet peaks; the links follow the
  row-major rank order: a 16-wide 'model' line spans two 8-card nodes,
  a 2x2 mesh's lines stay in one.
* ``roofline_terms``' compute and memory terms are the reference's
  arithmetic over the H100's peaks, its collective term the ring wire
  bytes of each group over its link, and ``bound_s`` a kernel's larger
  time.
"""

import dataclasses

import pytest

from repro import configs as rconfigs
from repro.core import roofline as rroof
from repro_torch import configs as tconfigs
from repro_torch.core import roofline as troof

ARCHS = rconfigs.names()
LIVE = [(a, s, m) for m in ('single', 'multi') for a in ARCHS
        for s in rconfigs.SHAPES
        if rconfigs.cell_is_live(rconfigs.get(a), s)]
CHIPS = {'single': 256, 'multi': 512}


def test_config_facts_equal_the_reference():
    assert tconfigs.names() == ARCHS and len(ARCHS) == 10
    assert tconfigs.SHAPES == rconfigs.SHAPES
    for a in ARCHS:
        r, t = rconfigs.get(a), tconfigs.get(a)
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()
        for s in rconfigs.SHAPES:
            assert tconfigs.cell_is_live(t, s) == rconfigs.cell_is_live(r, s)
    assert len(LIVE) == 64


@pytest.mark.parametrize('arch,shape,mesh', LIVE)
def test_analytic_model_equals_the_reference(arch, shape, mesh):
    for remat in (True, False):
        assert dataclasses.astuple(troof.flops_for_cell(
            arch, shape, remat_full=remat)) == dataclasses.astuple(
            rroof.flops_for_cell(arch, shape, remat_full=remat))
    assert troof.hbm_bytes_for_cell(arch, shape, CHIPS[mesh]) == \
        rroof.hbm_bytes_for_cell(arch, shape, CHIPS[mesh])
    r, t = rconfigs.get(arch), tconfigs.get(arch)
    sh = rconfigs.SHAPES[shape]
    assert troof.cache_bytes(t, sh['global_batch'], sh['seq_len']) == \
        rroof.cache_bytes(r, sh['global_batch'], sh['seq_len'])
    for hw in (True, False):
        assert troof.matmul_flops_per_token(t, hw=hw) == \
            rroof.matmul_flops_per_token(r, hw=hw)
    for decode in (True, False):
        assert troof.attention_flops_per_token(t, sh['seq_len'],
                                               decode=decode) == \
            rroof.attention_flops_per_token(r, sh['seq_len'], decode=decode)


def test_constants_are_the_h100s():
    assert troof.PEAK_FLOPS_BF16 == 989.4e12
    assert troof.PEAK_FLOPS_INT8 == 1978.9e12
    assert troof.HBM_BW == 3.35e12
    assert troof.NVLINK_BW == 450e9 and troof.NET_BW == 50e9
    assert troof.TRAIN_GRAD_ACCUM == rroof.TRAIN_GRAD_ACCUM


def test_links_follow_the_rank_order():
    single = dict(data=16, model=16)
    multi = dict(pod=2, data=16, model=16)
    assert troof._line_ranks(single, ('model',)) == list(range(16))
    assert troof._line_ranks(single, ('data',)) == list(range(0, 256, 16))
    assert troof._line_ranks(multi, ('pod',)) == [0, 256]
    for shape in (single, multi):
        for axes in (('model',), ('data',), ('data', 'model')):
            assert troof.crosses_nodes(shape, axes)
            assert troof.link_bw(shape, axes) == troof.NET_BW
    small = dict(data=2, model=2)
    for axes in (('model',), ('data',), ('data', 'model')):
        assert not troof.crosses_nodes(small, axes)
        assert troof.link_bw(small, axes) == troof.NVLINK_BW
    assert troof.crosses_nodes(dict(data=2, model=8), ('data',))
    assert not troof.crosses_nodes(dict(data=2, model=8), ('model',))


def test_wire_bytes_are_ring_costs():
    assert troof.wire_bytes('all_gather', 1600, 16) == 1500
    assert troof.wire_bytes('reduce_scatter', 1600, 16) == 1500
    assert troof.wire_bytes('all_to_all', 1600, 16) == 1500
    assert troof.wire_bytes('all_reduce', 1600, 16) == 3000
    assert troof.wire_bytes('all_reduce', 1600, 1) == 0


@pytest.mark.parametrize('arch,shape', [('stablelm-1.6b', 'train_4k'),
                                        ('deepseek-v3-671b', 'decode_32k'),
                                        ('mamba2-780m', 'long_500k')])
def test_roofline_terms(arch, shape):
    by_axes = [dict(kind='all_gather', axes=['data'], bytes=3.2e9),
               dict(kind='all_reduce', axes=['model'], bytes=1.6e8)]
    rec = dict(n_chips=256, mesh='single', mesh_shape=dict(data=16,
                                                           model=16),
               collectives=dict(by_axes=by_axes), flops=1.0,
               memory=dict(peak_bytes=2 ** 30))
    for int8 in (False, True):
        got = troof.roofline_terms(arch, shape, rec, int8=int8)
        fl = rroof.flops_for_cell(arch, shape)
        hbm = rroof.hbm_bytes_for_cell(arch, shape, 256)
        peak = 1978.9e12 if int8 else 989.4e12
        assert got['compute_s'] == fl.hw_flops / (256 * peak)
        assert got['memory_s'] == hbm['total'] / 3.35e12
        assert got['collective_s'] == pytest.approx(
            (3.2e9 * 15 / 16 + 1.6e8 * 2 * 15 / 16) / 50e9)
        terms = {k: got[k] for k in ('compute_s', 'memory_s',
                                     'collective_s')}
        assert got['dominant'] == max(terms, key=terms.get)
        assert got['step_time_lower_bound_s'] == max(terms.values())
        assert got['peak_mem_gib'] == 1.0


def test_bound_s():
    assert troof.bound_s(3.35e12) == 1.0
    assert troof.bound_s(0, 1978.9e12) == 1.0
    assert troof.bound_s(3.35e12, 2 * 989.4e12, troof.PEAK_FLOPS_BF16) == 2.0
