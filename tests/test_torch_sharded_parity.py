"""Sharded training on a 2x2 gloo rank mesh (``runtime/train_step.py::
sharded_train_step``) against the reference and the port's one-device
step, on the CPU.

* The 8 rows of tests/dist_parity_main.py (stablelm; deepseek-v3 and
  qwen2-moe with ``impl='ep'`` and capacity factor 100; mamba2; each under
  the 'tp' and 'fsdp2d' layouts), from the reference's seed-0 weights and
  batch: the sharded loss within 0.02 relative of the reference's
  one-device ``loss_fn`` (its own bound, tests/test_distributed_parity.py)
  and within 1e-3 of the port's one-device loss.
* One sharded AdamW step of stablelm (bf16 under both layouts, grad_accum
  1 and 2, and with the int8 error-feedback compression, whose scale is
  each whole leaf's; w8a8 under 'tp') and of qwen2-moe expert-parallel (against the
  one-device step on a mesh of one rank) against ``make_train_step`` on
  the same weights and batch: loss and grad norm and the whole params to
  tests/test_torch_train_step.py's bounds, the moments within 3e-2 of
  theirs (the error's norm);
  each rank's masters and moments the bytes its blocks have; the
  collectives a step makes and a loss-only forward makes, counted.
* The int8 error-feedback compression on a rank's blocks equals the
  one-device compression of the whole leaves, bit for bit.
* A sharded state saved on the 2x2 mesh under 'tp' restores onto a 4x1
  mesh under 'fsdp2d' (``checkpoint/ckpt.py``), block for block.
* The open CPU fault of serving TP: a rank's bf16 q/k/v columns at 128
  rows and stablelm's published K = N = 2048 equal the same columns of
  the whole product bit for bit (``yoco_linear.column_linears``).

One spawned group of four gloo ranks runs every job."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.yoco_linear import YocoConfig as RYocoConfig
from repro.data import synthetic as rsynthetic
from repro.models import model as rmodel
from repro_torch import configs as tconfigs
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.distributed import ranks, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.model import ModelRuntime
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as tTS

JOB = 'repro_torch.runtime.train_step:sharded_job'
ROWS = {'dense': ('stablelm-1.6b', False), 'mla_moe': ('deepseek-v3-671b', True),
        'gqa_moe': ('qwen2-moe-a2.7b', True), 'ssm': ('mamba2-780m', False)}
LAYOUTS = ('tp', 'fsdp2d')
MOE = 'qwen2-moe-a2.7b'
LR = 1e-3
# the moments' error norm relative to theirs: each rank's bf16 partial
# products (and, under 'tp', the row blocks' partial cotangents) round
# apart from the one device's whole product (measured 0.6-2.1%)
MOMENT_TOL = 3e-2
STEPS = (('bf16', 'tp', 1), ('bf16', 'tp', 2), ('bf16', 'fsdp2d', 1),
         ('bf16', 'fsdp2d', 2), ('w8a8', 'tp', 1))
# the int8 error-feedback compression: each leaf's scale the whole leaf's
COMPRESSED = (('bf16', 'tp', 1), ('bf16', 'fsdp2d', 1))
# qwen2-moe expert-parallel (capacity 100) against the one-device step on
# a mesh of one rank, where moe_ep is the whole batch's capacity dispatch,
# computing in f32 (on the bf16 weights): in bf16 the shards' capacity
# buffers and shared-expert products round apart from the whole batch's
# (3.2% of params off by > 1e-6 after a step under 'tp'; 3e-6 of the loss
# in f32)
EP_STEPS = (('tp', 1), ('fsdp2d', 2))


def _ep(cfg, impl):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=impl, capacity_factor=100.0))


def _row_inputs(arch):
    """The reference's seed-0 weights and batch (4 x 32), as numpy."""
    cfg = rconfigs.get(arch, smoke=True)
    params = jax.tree.map(np.asarray, rmodel.init_params(jax.random.key(0),
                                                         cfg))
    batch = rsynthetic.make_batch(rsynthetic.for_arch(cfg, global_batch=4,
                                                      seq_len=32), 0)
    return params, {k: np.asarray(v) for k, v in batch.items()}


def _opt(accum, compress=False):
    return adamw.OptConfig(lr=LR, warmup_steps=1, total_steps=10,
                           grad_accum=accum, compress_grads=compress)


def _step_cfg(arch):
    cfg = tconfigs.get(arch, smoke=True)
    return _ep(cfg, 'ep') if cfg.moe is not None else cfg


def _step_inputs(arch='stablelm-1.6b'):
    cfg = _step_cfg(arch)
    params, _ = ttrain.init_state(cfg, adamw.OptConfig(), 0, 'cpu')
    batch = rsynthetic.make_batch(rsynthetic.for_arch(
        rconfigs.get(arch, smoke=True), global_batch=8, seq_len=32), 0)
    return (tmodel.params_to_numpy(params, cfg),
            {k: np.asarray(v) for k, v in batch.items()})


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    jobs = []
    for name, (arch, ep) in ROWS.items():
        params, batch = _row_inputs(arch)
        cfg = _ep(tconfigs.get(arch, smoke=True), 'ep') if ep else \
            tconfigs.get(arch, smoke=True)
        for layout in LAYOUTS:
            jobs.append(ranks.mesh_job(JOB, 2, cfg=cfg, params=params,
                                       batch=batch, layout=layout))
    params, batch = _step_inputs()
    cfg = tconfigs.get('stablelm-1.6b', smoke=True)
    for mode, layout, accum in STEPS:
        jobs.append(ranks.all_ranks_job(ranks.mesh_job(
            JOB, 2, cfg=cfg, params=params, batch=batch, layout=layout,
            mode=mode, opt_cfg=_opt(accum), steps=1)))
    for mode, layout, accum in COMPRESSED:
        jobs.append(ranks.all_ranks_job(ranks.mesh_job(
            JOB, 2, cfg=cfg, params=params, batch=batch, layout=layout,
            mode=mode, opt_cfg=_opt(accum, compress=True), steps=1)))
    params, batch = _step_inputs(MOE)
    for layout, accum in EP_STEPS:
        jobs.append(ranks.all_ranks_job(ranks.mesh_job(
            JOB, 2, cfg=_step_cfg(MOE), params=params, batch=batch,
            layout=layout, opt_cfg=_opt(accum), steps=1,
            compute_dtype=torch.float32)))
    params, batch = _step_inputs()
    jobs.append(('repro_torch.checkpoint.ckpt:sharded_restore_job', dict(
        cfg=cfg, params=params, batch=batch, opt_cfg=_opt(1),
        ckpt_dir=str(tmp_path_factory.mktemp('sharded_ckpt')))))
    grads, efs, specs = _compression_inputs()
    jobs.append(ranks.mesh_job('repro_torch.optim.adamw:compression_job', 2,
                               grads=grads, efs=efs, specs=specs))
    outs = ranks.run(jobs, ranks.placement(4, 'cpu'))
    n = 2 * len(ROWS)
    losses = {(name, layout): outs[i * 2 + j]
              for i, name in enumerate(ROWS) for j, layout in
              enumerate(LAYOUTS)}
    steps = dict(zip(STEPS, outs[n:n + len(STEPS)]))
    n += len(STEPS)
    steps.update(zip([('compressed',) + c for c in COMPRESSED],
                     outs[n:n + len(COMPRESSED)]))
    n += len(COMPRESSED)
    steps.update(zip([(MOE,) + c for c in EP_STEPS],
                     outs[n:n + len(EP_STEPS)]))
    return losses, steps, outs[-2], outs[-1]


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('name', list(ROWS))
def test_sharded_loss_matches_reference_and_one_device(group, name, layout):
    arch, ep = ROWS[name]
    params, batch = _row_inputs(arch)
    rcfg = _ep(rconfigs.get(arch, smoke=True), 'dense')
    want = float(jax.jit(lambda p, b: rmodel.loss_fn(
        p, b, rcfg, RYocoConfig(mode='bf16'))[0])(
            params, jax.tree.map(jnp.asarray, batch)))
    tcfg = _ep(tconfigs.get(arch, smoke=True), 'dense')
    tp = tmodel.k_major_linear_weights(tmodel.params_from_numpy(
        params, tcfg, 'cpu'))
    with torch.no_grad():
        one = float(tmodel.loss_fn(tTS.cast_params(tp), {
            k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
            YocoConfig())[0])
    got = group[0][(name, layout)]['loss']
    assert abs(got - want) / abs(want) < 0.02, (got, want)
    assert abs(got - one) / abs(one) <= 1e-3, (got, one)


def _rel_norm(a, b):
    num = den = 0.0
    for k in a:
        if isinstance(a[k], dict):
            n, d = _rel_norm(a[k], b[k])
        else:
            n = float(np.sum((a[k] - b[k]) ** 2))
            d = float(np.sum(b[k] ** 2))
        num, den = num + n, den + d
    return num, den


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}/'))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize('arch,mode,layout,accum,compress', [
    ('stablelm-1.6b',) + c + (False,) for c in STEPS] + [
    ('stablelm-1.6b',) + c + (True,) for c in COMPRESSED] + [
    (MOE, 'bf16') + c + (False,) for c in EP_STEPS])
def test_sharded_step_matches_make_train_step(group, arch, mode, layout,
                                              accum, compress):
    params, batch = _step_inputs(arch)
    cfg = _step_cfg(arch)
    tp = tmodel.k_major_linear_weights(tmodel.params_from_numpy(
        params, cfg, 'cpu'))
    opt = _opt(accum, compress)
    rt, yoco = ModelRuntime(), YocoConfig(mode=mode)
    if cfg.moe is not None:
        # moe_ep on a mesh of one rank: every collective the identity
        rt = ModelRuntime(mesh=tmesh.shape_mesh(dict(data=1, model=1), 0),
                          use_ep=True, compute_dtype=torch.float32)
        yoco = YocoConfig(mode=mode, compute_dtype=torch.float32)
    p1, s1, m1 = tTS.make_train_step(cfg, yoco, rt, opt_cfg=opt)(
        tp, adamw.init(tp, opt), {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    outs = group[1][(arch, layout, accum) if cfg.moe is not None
                    else ('compressed', mode, layout, accum) if compress
                    else (mode, layout, accum)]
    m = outs[0]['metrics'][0]
    assert abs(m['loss'] - float(m1['loss'])) <= 1e-3 * abs(float(m1['loss']))
    assert abs(m['grad_norm'] - float(m1['grad_norm'])) <= \
        5e-3 * float(m1['grad_norm'])
    assert m['lr'] == float(m1['lr'])
    want = _flat(tmodel.params_to_numpy(p1, cfg))
    got = _flat(outs[0]['params'])
    assert want.keys() == got.keys()
    off = total = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert float(d.max()) <= 2.2 * LR, k
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= 0.03 * total, (off, total)
    for name, tree in (('mu', s1.mu), ('nu', s1.nu)):
        num, den = _rel_norm(outs[0][name], tmodel.params_to_numpy(tree,
                                                                    cfg))
        assert num ** 0.5 <= MOMENT_TOL * den ** 0.5, (name, num, den)
    # each rank holds its blocks: the specs' bytes of masters and moments
    mesh = tmesh.shape_mesh(dict(data=2, model=2))
    pabs, oabs = tTS.abstract_state(cfg, opt)
    pspecs, _, _ = tTS.state_shardings(mesh, cfg, pabs, oabs, layout)
    whole = sharding.nbytes(pabs)
    for o in outs:
        cut = tmesh.shape_mesh(mesh.shape, rank=o['rank'])
        want_bytes = sharding.nbytes(sharding.shard_tree(
            tp, pspecs, cut))
        assert o['master_bytes'] == want_bytes
        assert o['moment_bytes'] == 2 * want_bytes
        assert whole / 4 <= o['master_bytes'] < whole / 2
    # the step's collectives: every gathered leaf's all-gather and its
    # reduce-scatter, a microbatch each
    calls = outs[0]['calls']
    assert calls['all_gather'] >= calls['reduce_scatter'] > 0
    # EP: each MoE layer's two all_to_alls, and their two in the backward
    n_moe = cfg.n_layers if cfg.moe is not None else 0
    assert calls['all_to_all'] == 4 * n_moe * accum
    assert calls['heads_all_gather'] == 0
    assert all(o['calls'] == calls for o in outs)


def _compression_inputs():
    rng = np.random.RandomState(5)
    shapes = dict(a=(8, 12), b=(8, 12), c=(16,), d=(6, 8))
    # cut over 'data' and 'model', both, one, or none (replicated)
    specs = dict(a=('data', 'model'), b=(('data', 'model'), None),
                 c=('model',), d=(None, None))
    grads = {k: (rng.randn(*v) * (1 + 9 * (k == 'a'))).astype(np.float32)
             for k, v in shapes.items()}
    efs = {k: (rng.randn(*v) * 0.01).astype(np.float32)
           for k, v in shapes.items()}
    return grads, efs, specs


def test_compression_scales_are_the_whole_leaves(group):
    """int8 error-feedback compression on a rank's blocks equals the
    one-device compression of the whole leaves, bit for bit: each
    block's scale is its whole leaf's (an all-reduce MAX)."""
    grads, efs, _ = _compression_inputs()
    wire, state = adamw.apply_compression(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        adamw.OptState(0, None, None,
                       {k: torch.from_numpy(v) for k, v in efs.items()}))
    got = group[3]
    for k in grads:
        np.testing.assert_array_equal(got['wire'][k], wire[k].numpy())
        np.testing.assert_array_equal(got['ef'][k], state.ef[k].numpy())


def test_sharded_state_restores_onto_another_mesh(group):
    out = group[2]
    assert out['blocks_equal'] and out['manifest_step'] == 1
    assert np.isfinite(out['saved_loss']) and np.isfinite(
        out['restored_loss'])


class _Group:
    """A serving TP group's rank and size, no process group."""

    def __init__(self, rank, size):
        self._rank, self._size = rank, size

    def rank(self):
        return self._rank

    def size(self):
        return self._size


@pytest.mark.parametrize('tp', [2, 4])
def test_rank_qkv_columns_equal_the_whole_product_at_published_width(tp):
    """stablelm-1.6b's q/k/v (K = N = 2048, bf16) at 128 rows: each
    rank's head columns equal the whole product's, bit for bit."""
    cfg = tconfigs.get('stablelm-1.6b', smoke=False)
    gen = torch.Generator().manual_seed(0)
    d = cfg.d_model
    p = {k: (torch.randn((d, d), generator=gen) * d ** -0.5).to(
        torch.bfloat16) for k in ('wq', 'wk', 'wv')}
    x = torch.randn((1, 128, d), generator=gen).to(torch.bfloat16)
    pos = torch.arange(128)[None]
    yoco = YocoConfig()
    whole = tattn._project_qkv(p, x, cfg, yoco, pos, cfg.rope_theta)
    h = cfg.n_heads // tp
    for r in range(tp):
        part = sharding.shard_serve_params(dict(attn=p), r, tp)['attn']
        got = tattn._project_qkv(part, x, cfg, yoco, pos, cfg.rope_theta,
                                 ModelRuntime(tp_group=_Group(r, tp)))
        for g, w in zip(got, whole):
            assert torch.equal(g, w[:, :, r * h:(r + 1) * h]), r
