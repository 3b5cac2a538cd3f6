"""The port's checkpoints (``repro_torch.checkpoint.ckpt``), the numpy bridge
back to the reference's tree (``models.model.params_to_numpy``) and the
data stream's shards, on the CPU.

* The reference's ``tests/test_fault_tolerance.py`` checkpoint cases on the
  port: round trip, GC keeping the last k, shape mismatch (``ValueError``)
  and a missing leaf (``KeyError``), a ``.tmp`` directory never restorable,
  the async save joined.
* Cross-restore, bit-equal both ways: a checkpoint of (params, AdamW
  state) written by the reference's ``CheckpointManager`` restores in the
  port, and the port's in the reference; restore copies into the
  template's tensors, so K-major masters stay K-major.
* ``params_to_numpy`` inverts ``params_from_numpy`` bit for bit on every
  config (QuantizedWeight trees too).
* The synthetic stream: a shard's batch is a pure function of (seed, step,
  shard), shard 0 of one shard is the unsharded stream, ``iterate`` walks
  the steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint.ckpt import CheckpointManager as RefManager
from repro.core import yoco_linear as ryl
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw

ARCH = 'stablelm-1.6b'


def _ref_state(seed=0):
    cfg = rconfigs.get(ARCH, smoke=True)
    params = rmodel.init_params(jax.random.key(seed), cfg)
    opt = radamw.init(params, radamw.OptConfig())
    # non-zero moments and step, so a restore that drops them shows
    opt = opt._replace(
        step=jnp.int32(7),
        mu=jax.tree.map(lambda p: p * 0.5, params),
        nu=jax.tree.map(lambda p: p * p, params))
    return params, opt


def _port_state(seed=1):
    """A port (params, AdamW state) with K-major masters, drawn from
    ``seed`` (not the reference's values)."""
    from repro_torch.launch.train import init_state
    return init_state(tconfigs.get(ARCH, smoke=True), tadamw.OptConfig(),
                      seed, 'cpu')


def _leaves_np(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _port_state()
    want = [t.clone() for t in tadamw.tree_leaves((params, opt))]
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, (params, opt), extra=dict(loss=1.0))
    p2, o2 = _port_state(seed=2)
    (p3, o3), manifest = mgr.restore((p2, o2))
    assert manifest['step'] == 7 and manifest['extra'] == dict(loss=1.0)
    assert p3 is p2 and o3 is o2                 # filled in place
    for a, b in zip(want, tadamw.tree_leaves((p3, o3))):
        assert torch.equal(a, b)
    wq = p3['layers'][0]['attn']['wq']
    assert wq.t().is_contiguous() and o3.mu['layers'][0]['attn']['wq'] \
        .t().is_contiguous()


def test_checkpoint_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {'w': torch.ones((4, 4))})
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {'w': torch.ones((4, 4)), 'layers': [{'a': torch.ones(3)}]})
    with pytest.raises(ValueError, match='shape'):
        mgr.restore({'w': torch.ones((8, 8)),
                     'layers': [{'a': torch.ones(3)}]})
    # one layer more than the checkpoint holds
    with pytest.raises(ValueError, match='shape'):
        mgr.restore({'w': torch.ones((4, 4)),
                     'layers': [{'a': torch.ones(3)}] * 2})
    with pytest.raises(KeyError, match='missing leaf'):
        mgr.restore({'w': torch.ones((4, 4)), 'v': torch.ones(2),
                     'layers': [{'a': torch.ones(3)}]})


def test_tmp_dir_never_visible_as_checkpoint(tmp_path):
    """A crashed half-written save must not be restorable."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    os.makedirs(os.path.join(str(tmp_path), 'step_00000009.tmp'))
    assert mgr.latest_step() is None
    mgr.save(3, {'w': torch.ones(2)})
    assert mgr.latest_step() == 3
    assert not any(n.endswith('.tmp') and n != 'step_00000009.tmp'
                   for n in os.listdir(str(tmp_path)))


def test_async_save_joins_cleanly(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.ones((256, 256))
    mgr.save(1, {'w': w})
    w.zero_()                   # the save copied it to the host already
    mgr.save(2, {'w': w})       # joins the first before starting
    mgr.wait()
    assert mgr.latest_step() == 2
    got, _ = mgr.restore({'w': torch.empty((256, 256))}, step=1)
    assert torch.equal(got['w'], torch.ones((256, 256)))


def test_async_save_error_raises_on_wait(tmp_path):
    """A background save that fails (here: its directory is a file) raises
    in the next wait instead of vanishing with its thread."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    open(os.path.join(str(tmp_path), 'step_00000001.tmp'), 'w').close()
    mgr.save(1, {'w': torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                  # the error is reported once
    assert mgr.latest_step() is None


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _ref_state()
    RefManager(str(tmp_path), async_save=False).save(
        5, (params, opt), extra=dict(arch=ARCH))
    tp, to = _port_state()
    (tp, to), manifest = CheckpointManager(str(tmp_path)).restore((tp, to))
    assert manifest['step'] == 5 and int(to.step) == 7
    cfg = tconfigs.get(ARCH, smoke=True)
    for want, got in ((params, tp), (opt.mu, to.mu), (opt.nu, to.nu)):
        for a, b in zip(_leaves_np(want),
                        _leaves_np(tmodel.params_to_numpy(got, cfg))):
            np.testing.assert_array_equal(a, b)
    assert tp['lm_head'].t().is_contiguous()


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tp, to = _port_state()
    CheckpointManager(str(tmp_path), async_save=False).save(4, (tp, to))
    params, opt = _ref_state()
    (rp, ro), manifest = RefManager(str(tmp_path)).restore((params, opt))
    assert manifest['step'] == 4 and int(ro.step) == 0
    cfg = tconfigs.get(ARCH, smoke=True)
    for want, got in ((tp, rp), (to.mu, ro.mu), (to.nu, ro.nu)):
        for a, b in zip(_leaves_np(tmodel.params_to_numpy(want, cfg)),
                        _leaves_np(got)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('arch,prequant', (
    [(a, False) for a in ('stablelm-1.6b', 'gemma3-27b', 'deepseek-v3-671b',
                          'qwen2-moe-a2.7b', 'mamba2-780m', 'zamba2-1.2b',
                          'qwen2-vl-72b', 'musicgen-large')]
    + [('stablelm-1.6b', True), ('qwen2-moe-a2.7b', True)]))
def test_params_to_numpy_inverts_params_from_numpy(arch, prequant):
    cfg = rconfigs.get(arch, smoke=True)
    ref = rmodel.init_params(jax.random.key(0), cfg)
    if prequant:
        ref = ryl.quantize_tree(ref)
    tree = jax.tree.map(np.asarray, ref)
    tcfg = tconfigs.get(arch, smoke=True)
    port = tmodel.params_from_numpy(tree, tcfg, 'cpu')
    if not prequant:
        port = tmodel.k_major_linear_weights(port)
    back = tmodel.params_to_numpy(port, tcfg)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    assert want.keys() == got.keys()
    for k, x in want.items():
        assert x.dtype == got[k].dtype and x.shape == got[k].shape, k
        np.testing.assert_array_equal(x, got[k])
    again = tmodel.params_from_numpy(back, tcfg, 'cpu')
    for x, y in zip(tadamw.tree_leaves(port), tadamw.tree_leaves(again)):
        assert torch.equal(x, y)
    assert tmodel.param_count(port) == rmodel.param_count(ref)


def test_data_shards_are_pure_functions_of_seed_step_shard():
    cfg = tconfigs.get(ARCH, smoke=True)
    full = synthetic.make_batch(synthetic.for_arch(cfg, global_batch=8,
                                                   seq_len=16), 3)
    whole = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=8, seq_len=16, n_shards=1, shard=0), 3)
    assert torch.equal(full['inputs'], whole['inputs'])
    parts = [synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=8, seq_len=16, n_shards=2, shard=s), 3)
        for s in range(2)]
    assert parts[0]['inputs'].shape == (4, 16)
    assert not torch.equal(parts[0]['inputs'], parts[1]['inputs'])
    again = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=8, seq_len=16, n_shards=2, shard=0), 3)
    assert torch.equal(parts[0]['inputs'], again['inputs'])
    assert torch.equal(parts[0]['labels'][:, :-1], parts[0]['inputs'][:, 1:])
    with pytest.raises(ValueError, match='shards'):
        synthetic.make_batch(synthetic.for_arch(cfg, global_batch=8,
                                                n_shards=3), 0)


def test_iterate_walks_the_steps():
    dc = synthetic.for_arch(tconfigs.get('musicgen-large', smoke=True),
                            global_batch=2, seq_len=8)
    batches = list(synthetic.iterate(dc, start_step=5, n_steps=3))
    assert len(batches) == 3 and batches[0]['inputs'].shape == (2, 8, 4)
    for i, b in enumerate(batches):
        assert torch.equal(b['inputs'],
                           synthetic.make_batch(dc, 5 + i)['inputs'])
