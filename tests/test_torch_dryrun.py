"""The production-mesh dry run (``launch/dryrun.py``) on the CPU.

* Its records hold to ``tests/test_dryrun_artifacts.py``'s checks, run
  live rather than read from a sweep: ``n_chips`` 256 / 512 and the mesh
  shape, FLOPs and peak bytes above 0 (stablelm-1.6b decode_32k on both
  meshes, and in w8a8 with int8 weights resident), a train cell's
  all-reduce bytes above 0, deepseek-v3-671b train_4k's all-to-all bytes
  above 0, and gemma3-27b train_4k's multi-pod peak at most 1.1 times its
  single-pod peak. The train cells run at grad_accum 1 (one microbatch of
  the cell's whole global batch): the same step at an eighth of the ops,
  so the file stays within its time.
* Against real ranks: stablelm smoke's sharded train step (bf16 'tp',
  remat 'full'), prefill and decode step on a 2x2 gloo group (the setup
  of ``tests/test_torch_sharded_parity.py``) make exactly the
  collectives, by kind, in calls and bytes, that the dry run of the same
  steps counts on the meta device, and a rank's master, moment, weight
  and cache bytes equal the dry run's argument bytes.
* ``torch.distributed`` is left as it was found, and the dry run refuses
  to start inside an initialised group.
* The gloo staging term (``GLOO_CUDA_STAGING``) adds a reduce-scatter's
  input copy and an all-gather's output copy to the peak, and nothing
  for an all-reduce.
* The CLI writes one record per cell, and its table reads them.
* The kernels the dry run reaches (K2, K3, K4, K7) take their shape-only
  route on meta tensors: the kernels' shapes and dtypes, FLOP formulas,
  no launch.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.distributed import ranks
from repro_torch.kernels import build, meta, ops, yoco_vmm
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as tmesh

SMOKE = 'stablelm-1.6b'
TRAIN = dict(kind='train', global_batch=8, seq_len=32)
PREFILL = dict(kind='prefill', global_batch=4, seq_len=6, max_seq=12)
DECODE = dict(kind='decode', global_batch=4, seq_len=6, max_seq=12)


@pytest.fixture(scope='module')
def cells():
    out = {}
    for mesh in ('single', 'multi'):
        out['decode', mesh] = DR.dryrun_cell(SMOKE, 'decode_32k', mesh,
                                             verbose=False)
        out['gemma3', mesh] = DR.dryrun_cell('gemma3-27b', 'train_4k', mesh,
                                             verbose=False, grad_accum=1)
    out['deepseek'] = DR.dryrun_cell('deepseek-v3-671b', 'train_4k',
                                     'single', verbose=False, grad_accum=1)
    out['prequant'] = DR.dryrun_cell(SMOKE, 'decode_32k', 'single',
                                     verbose=False, yoco_mode='w8a8',
                                     prequant=True)
    return out


@pytest.mark.parametrize('key', [('decode', 'single'), ('decode', 'multi'),
                                 ('gemma3', 'single'), ('gemma3', 'multi'),
                                 'deepseek', 'prequant'])
def test_cell_record_sane(cells, key):
    rec = cells[key]
    multi = rec['mesh'] == 'multi'
    assert rec['n_chips'] == (512 if multi else 256)
    assert rec['mesh_shape'] == ({'pod': 2, 'data': 16, 'model': 16}
                                 if multi else {'data': 16, 'model': 16})
    assert rec['flops'] > 0
    assert rec['memory']['peak_bytes'] >= rec['argument_bytes']['total'] > 0
    assert rec['dryrun_s'] > 0
    terms = rec['roofline']
    assert terms['dominant'] in ('compute_s', 'memory_s', 'collective_s')
    assert terms['step_time_lower_bound_s'] == max(
        terms['compute_s'], terms['memory_s'], terms['collective_s']) > 0
    json.dumps(rec)


def test_train_cells_have_gradient_allreduce(cells):
    assert cells['gemma3', 'single']['collectives']['bytes'][
        'all_reduce'] > 0


def test_moe_cells_have_all_to_all(cells):
    assert cells['deepseek']['collectives']['bytes']['all_to_all'] > 0


def test_multi_pod_shards_the_pod_axis(cells):
    s = cells['gemma3', 'single']['memory']['peak_bytes']
    m = cells['gemma3', 'multi']['memory']['peak_bytes']
    assert m <= s * 1.1


def test_prequant_cell_holds_int8_weights(cells):
    b16 = cells['decode', 'single']['argument_bytes']
    q8 = cells['prequant']['argument_bytes']
    assert q8['cache'] == b16['cache']
    assert q8['params'] < b16['params']


# ----------------------------------------------------------------------------
# against real ranks
# ----------------------------------------------------------------------------
def _mesh():
    return tmesh.shape_mesh(dict(data=2, model=2))


@pytest.fixture(scope='module')
def real_ranks():
    cfg = configs.get(SMOKE, smoke=True)
    batch = {k: v.numpy() for k, v in synthetic.make_batch(
        synthetic.for_arch(cfg, global_batch=TRAIN['global_batch'],
                           seq_len=TRAIN['seq_len']), 0).items()}
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 6)).astype(np.int64)
    jobs = [ranks.all_ranks_job(ranks.mesh_job(
        'repro_torch.runtime.train_step:sharded_job', 2, cfg=cfg,
        batch=batch, steps=1, remat='full', device='cpu')),
        ranks.all_ranks_job(ranks.mesh_job(
            'repro_torch.runtime.serve_step:sharded_serve_job', 2, cfg=cfg,
            prompts=prompts, steps=1, max_seq=12, device='cpu'))]
    return ranks.run(jobs, ranks.placement(4, 'cpu'))


def test_dryrun_counts_the_train_step_ranks_make(real_ranks):
    cfg = configs.get(SMOKE, smoke=True)
    rec = DR.dryrun_step(cfg, TRAIN, _mesh(), grad_accum=1)
    coll = rec['collectives']
    for o in real_ranks[0]:
        assert {k: o['calls'][k] for k in coll['calls']} == coll['calls']
        assert o['bytes'] == coll['bytes']
        assert o['master_bytes'] == rec['argument_bytes']['params']
        assert o['moment_bytes'] == rec['argument_bytes']['opt']
    assert coll['bytes']['all_gather'] > 0
    assert coll['bytes']['reduce_scatter'] > 0


@pytest.mark.parametrize('i,shape', [(0, PREFILL), (1, DECODE)])
def test_dryrun_counts_the_serve_steps_ranks_make(real_ranks, i, shape):
    cfg = configs.get(SMOKE, smoke=True)
    rec = DR.dryrun_step(cfg, shape, _mesh())
    coll = rec['collectives']
    for o in real_ranks[1]:
        assert {k: o['calls'][i][k] for k in coll['calls']} == coll['calls']
        assert o['bytes'][i] == coll['bytes']
        assert o['param_bytes'] == rec['argument_bytes']['params']
        assert o['cache_bytes'] == rec['argument_bytes']['cache']


def test_dryrun_leaves_torch_distributed_as_found():
    assert not dist.is_initialized()
    DR.dryrun_step(configs.get(SMOKE, smoke=True), DECODE, _mesh())
    assert not dist.is_initialized()
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match='outside an initialised'):
            DR.dryrun_step(configs.get(SMOKE, smoke=True), DECODE, _mesh())
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_gloo_staging_counts_each_reduce_scatter_input_copy():
    """Under ``GLOO_CUDA_STAGING`` a reduce-scatter's call holds a copy of
    its whole input beside what is live (gloo clones it on the card
    before its host all-reduce) and an all-gather's a copy of its whole
    output; all-reduce stages nothing on the device, and without staging
    (NCCL) nothing is added."""
    from repro_torch.distributed import collectives
    x = torch.empty((8, 1024), device='meta')
    with DR.fake_world(_mesh()) as mesh:
        group = mesh.group(('model',))
        for staging, staged in ((None, False), (DR.GLOO_CUDA_STAGING, True)):
            live = DR.LiveBytes([x], staging)
            with live:
                out = collectives.reduce_scatter_dim(x, 0, group)
            # the input and the output block, and the input's copy
            assert live.peak == 32768 + 16384 + staged * 32768
            del out
            live = DR.LiveBytes([x], staging)
            with live:
                collectives.all_gather_dim(x, 0, group)
            # the input and the gathered output, and the output's copy
            assert live.peak == 32768 + 65536 + staged * 65536
            live = DR.LiveBytes([x], staging)
            with live:
                collectives.all_reduce(x, group)
            # the input and the clone all_reduce reduces in place
            assert live.peak == 32768 + 32768


def test_cli_writes_a_record_a_cell(tmp_path, capsys):
    DR.main(['--arch', 'mamba2-780m', '--shape', 'long_500k', '--mesh',
             'both', '--out', str(tmp_path)])
    for mesh in ('single', 'multi'):
        with open(os.path.join(tmp_path, mesh,
                               'mamba2-780m__long_500k.json')) as f:
            rec = json.load(f)
        assert rec['arch'] == 'mamba2-780m' and rec['mesh'] == mesh
    assert 'all 2 cells passed' in capsys.readouterr().out
    DR.main(['--table', '--out', str(tmp_path)])
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith('| mamba2-780m')]
    assert len(rows) == 1 and rows[0].count(' / ') >= 8


def test_kernels_take_their_shape_only_route_on_meta():
    """K2, K3, K4 and K7 on meta tensors: outputs of the kernels' shapes
    and dtypes, no launch, and ``FlopCounterMode`` counts 2·M·K·N for
    K2 and K4, none for K3, 4·B·Hkv·G·S·dh for K7; the shape-only ops
    refuse any other device."""
    build.reset_counts()
    m, k, n = 8, 64, 48
    x = torch.empty((m, k), device='meta')
    w = torch.empty((n, k), device='meta').t()          # K-major
    wq = torch.empty((n, k), dtype=torch.int8, device='meta').t()
    with FlopCounterMode(display=False) as fc:
        xq, sx = ops.quantize_rows(x)
    assert fc.get_total_flops() == 0
    assert (xq.dtype, tuple(xq.shape), sx.dtype, tuple(sx.shape)) == (
        torch.int8, (m, k), torch.float32, (m, 1))
    with FlopCounterMode(display=False) as fc:
        acc = ops.int8_matmul(xq, wq)
    assert fc.get_total_flops() == 2 * m * k * n
    assert (acc.dtype, tuple(acc.shape)) == (torch.int32, (m, n))
    with FlopCounterMode(display=False) as fc:
        y = yoco_vmm.yoco_vmm_int8(xq, wq, sx,
                                   torch.empty((1, n), device='meta'))
    assert fc.get_total_flops() == 2 * m * k * n
    assert (y.dtype, tuple(y.shape)) == (torch.float32, (m, n))
    assert ops.yoco_vmm(x, w).shape == (m, n)
    b, hkv, g, s, dh = 2, 4, 2, 40, 16
    q = torch.empty((b, 1, hkv * g, dh), device='meta')
    kv = torch.empty((b, s, hkv, dh), dtype=torch.bfloat16, device='meta')
    with FlopCounterMode(display=False) as fc:
        o = fd.flash_decode(q, kv, kv, torch.zeros((), dtype=torch.int32,
                                                   device='meta'),
                            scale=0.25)
    assert fc.get_total_flops() == 4 * b * hkv * g * s * dh
    assert (o.dtype, tuple(o.shape)) == (torch.bfloat16, tuple(q.shape))
    assert all(v == 0 for v in build.LAUNCHES.values())
    with pytest.raises(RuntimeError, match='shape-only'):
        meta.quantize_rows(torch.zeros((2, 4)))
