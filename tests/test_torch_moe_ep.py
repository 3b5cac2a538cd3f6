"""Expert-parallel MoE (``models/moe.py::moe_ep``) on a 2x2 gloo rank mesh
against the reference's ``moe_ep`` on its 2x2 mesh of host devices (the
counterpart of tests/test_moe.py:76): the same seeded inputs and expert
weights, in f32 (the shared experts' linears too), with capacity drops (capacity factor 1.25) — outputs
within 1e-5, the same drop fraction and the shards' mean aux loss — for
both entries of the port's tokens (each rank's 1/2 of the sequence, the
'2d' layout, and the whole sequence replicated over 'model', the 'tp'
layout, split inside). At capacity factor 100 (no drops) the outputs
equal the port's ``moe_dense`` on the whole batch, and so do the
gradients of a fixed linear functional of the outputs, through the two
``all_to_all``s and the entry's split and gather (the router's and the
shared experts' gradients summed over the shards). One spawned group of
four gloo ranks runs every case."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
import jax.numpy as jnp
from repro.core.yoco_linear import YocoConfig as RYocoConfig
from repro.models import moe as rmoe
from repro_torch import configs as tconfigs
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.distributed import ranks
from repro_torch.models import moe as tmoe

ARCHS = ('qwen2-moe-a2.7b', 'deepseek-v3-671b')
CAPS = (1.25, 100.0)
SPLITS = (True, False)


def _cfg(pkg, arch, cap):
    cfg = pkg.get(arch, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl='ep', capacity_factor=cap))


def _inputs(arch):
    cfg = rconfigs.get(arch, smoke=True)
    p = rmoe.init_moe(jax.random.key(8), cfg)
    x = jax.random.normal(jax.random.key(9), (4, 8, cfg.d_model)) * 0.5
    r = np.random.RandomState(3).randn(4, 8, cfg.d_model).astype(np.float32)
    return ({k: np.asarray(v, np.float32) for k, v in p.items()},
            np.asarray(x, np.float32), r)


def _assemble(outs, get, seq_split):
    """The global (B, S, ...) array from the ranks' blocks (rank = data *
    2 + model)."""
    rows = []
    for d in range(2):
        blocks = [get(outs[d * 2 + m]) for m in range(2)]
        rows.append(np.concatenate(blocks, 1) if seq_split else blocks[0])
    return np.concatenate(rows, 0)


@pytest.fixture(scope='module')
def group():
    keys, jobs = [], []
    for arch in ARCHS:
        p, x, r = _inputs(arch)
        for cap in CAPS:
            for split in SPLITS:
                keys.append((arch, cap, split))
                jobs.append(ranks.all_ranks_job(ranks.mesh_job(
                    'repro_torch.models.moe:moe_ep_job', 2,
                    cfg=_cfg(tconfigs, arch, cap), params=p, x=x, r=r,
                    seq_split=split, with_grads=cap == 100.0)))
    return dict(zip(keys, ranks.run(jobs, ranks.placement(4, 'cpu'))))


@pytest.mark.parametrize('split', SPLITS, ids=['seq-split', 'replicated'])
@pytest.mark.parametrize('arch', ARCHS)
def test_moe_ep_equals_the_reference_with_drops(group, arch, split):
    p, x, _ = _inputs(arch)
    cfg = _cfg(rconfigs, arch, 1.25)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ('data', 'model'))
    ctx = rmoe.EPContext(mesh, ('data',))
    want, wm = jax.jit(lambda p, x: rmoe.moe_ep(
        p, x, cfg, RYocoConfig(compute_dtype=jnp.float32), ctx))(p, x)
    outs = group[(arch, 1.25, split)]
    got = _assemble(outs, lambda o: o['y'], split)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert 0 < float(wm['drop_fraction']) < 1
    for k in ('drop_fraction', 'aux_loss', 'router_entropy'):
        for o in outs:
            assert abs(o['metrics'][k] - float(wm[k])) <= 1e-5 * max(
                1.0, abs(float(wm[k]))), (k, o['metrics'][k], float(wm[k]))


@pytest.mark.parametrize('split', SPLITS, ids=['seq-split', 'replicated'])
@pytest.mark.parametrize('arch', ARCHS)
def test_moe_ep_without_drops_equals_dense_with_gradients(group, arch,
                                                          split):
    p, x, r = _inputs(arch)
    cfg = _cfg(tconfigs, arch, 100.0)
    tp = {k: tmoe.stack_layout(k, torch.from_numpy(v))
          if k in tmoe.STACKS else torch.from_numpy(v)
          for k, v in p.items()}
    for v in tp.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tmoe.moe_dense(tp, xt, cfg, YocoConfig(
        compute_dtype=torch.float32))
    torch.sum(y * torch.from_numpy(r)).backward()
    outs = group[(arch, 100.0, split)]
    assert all(o['metrics']['drop_fraction'] == 0.0 for o in outs)
    np.testing.assert_allclose(_assemble(outs, lambda o: o['y'], split),
                               y.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_assemble(outs, lambda o: o['dx'], split),
                               xt.grad.numpy(), rtol=1e-5, atol=1e-5)
    e_loc = cfg.moe.stack_size // 2
    for k, v in tp.items():
        want = v.grad.numpy()
        if k in tmoe.STACKS:
            # the experts' rank holds their gradient, summed over dp rows
            got = np.concatenate([outs[m]['dp'][k] + outs[2 + m]['dp'][k]
                                  for m in range(2)])
            assert got.shape[0] == 2 * e_loc
        else:
            # summed over the shards (over dp only when replicated: the
            # 'model' ranks' copy_in already summed theirs)
            got = sum(o['dp'][k] for o in (outs if split else outs[::2]))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
