"""The port's training forward and train step against the reference, on the
CPU at smoke size, from the reference's seed-0 params carried over through
numpy and the same numpy batches.

* ``loss_fn`` and its gradients in f32 (f32 params, f32 compute) against
  ``jax.jit(jax.value_and_grad(repro.models.model.loss_fn))``, for eight
  configs (stablelm-1.6b, gemma3-27b's windows and sandwich norms,
  deepseek-v3's MLA and MoE, qwen2-moe's aux loss, mamba2-780m's scan,
  zamba2-1.2b's hybrid, qwen2-vl-72b's embeddings and M-RoPE,
  musicgen-large's codebooks) and stablelm in all four modes: the loss
  within 1e-5, each gradient leaf within 1e-5 of that leaf's max |g|
  (measured: 3.6e-6 at worst, zamba2's conv weights). analog_sim runs on
  the reference's draws (``test_torch_fidelity_linear.jax_normals``): its
  backward reaches y only through the TDC's per-tensor scale (the codes
  carry no gradient), and the port's ``amax`` splits it over ties as
  JAX's ``max`` does.
* the whole bf16 step against ``TS.make_train_step`` jitted: the bf16 cast
  makes the forward bf16 on both sides, rounded in different places, and
  AdamW's first step moves every param by about ±lr whatever the
  gradient's size, so a param whose gradient is near zero can flip sign.
  Held: the loss within 1e-3 and the gradient norm within 5e-3 relative
  (measured 5e-4 / 1.8e-3 in w8a8 / qat), the learning rate bit-equal, at
  most 3% of the params off by more than 1e-6 (measured 1.1-1.6%), each
  by at most 2.2 lr (a sign flip plus the decay).
* a step leaves every linear master, its moments and every expert stack
  in the layout the kernels read (K-major; ``moe.stack_layout``).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro.runtime import train_step as rTS
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import train_step as tTS

GRAD_TOL = 1e-5
LOSS_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return rmodel.init_params(jax.random.key(0), rconfigs.get(arch,
                                                              smoke=True))


def _np_params(arch):
    return jax.tree.map(np.asarray, _ref_params(arch))


def numpy_batch(cfg, b=2, s=8, seed=0):
    """Inputs and labels of every input kind from numpy; one label masked
    (-1)."""
    rs = np.random.RandomState(seed)
    if cfg.input_kind == 'embeddings':
        inputs = rs.randn(b, s, cfg.d_model).astype(np.float32)
        labels = rs.randint(0, cfg.vocab_size, (b, s))
    elif cfg.input_kind == 'codebooks':
        inputs = rs.randint(0, cfg.vocab_size, (b, s, cfg.n_codebooks))
        labels = rs.randint(0, cfg.vocab_size, (b, s, cfg.n_codebooks))
    else:
        inputs = rs.randint(0, cfg.vocab_size, (b, s))
        labels = rs.randint(0, cfg.vocab_size, (b, s))
    labels[0, 0] = -1
    if inputs.dtype != np.float32:
        inputs = inputs.astype(np.int32)
    return dict(inputs=inputs, labels=labels.astype(np.int32))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_params(arch, k_major=True):
    """The reference's seed-0 params as the port's tree, linear masters
    K-major as the trainer stores them."""
    p = tmodel.params_from_numpy(_np_params(arch),
                                 tconfigs.get(arch, smoke=True), 'cpu')
    return tmodel.k_major_linear_weights(p) if k_major else p


def _by_path(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture
def jax_draws(monkeypatch):
    """analog_sim on the reference's draws."""
    sys.path.insert(0, str(__import__('pathlib').Path(__file__).parent))
    from test_torch_fidelity_linear import jax_normals
    monkeypatch.setattr(tyl, 'analog_normals', jax_normals)


LOSS_CASES = ([('stablelm-1.6b', m) for m in tyl.MODES]
              + [(a, 'bf16') for a in ('gemma3-27b', 'deepseek-v3-671b',
                                       'qwen2-moe-a2.7b', 'mamba2-780m',
                                       'zamba2-1.2b', 'qwen2-vl-72b',
                                       'musicgen-large')])


@pytest.mark.parametrize('arch,mode', LOSS_CASES)
def test_loss_and_grads_match_reference(arch, mode, jax_draws):
    rcfg = rconfigs.get(arch, smoke=True)
    tcfg = tconfigs.get(arch, smoke=True)
    batch = numpy_batch(rcfg)
    ry = ryl.YocoConfig(mode=mode, compute_dtype=jnp.float32)
    rrt = rmodel.ModelRuntime(compute_dtype=jnp.float32)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss_fn(p, b, rcfg, ry, rrt), has_aux=True))(
        _ref_params(arch), jax.tree.map(jnp.asarray, batch))
    params = port_params(arch)
    for p in tadamw.tree_leaves(params):
        p.requires_grad_(True)
    got, gm = tmodel.loss_fn(
        params, _torch_batch(batch), tcfg,
        tyl.YocoConfig(mode=mode, compute_dtype=torch.float32),
        tmodel.ModelRuntime(compute_dtype=torch.float32))
    got.backward()
    assert abs(float(want) - float(got.detach())) <= LOSS_TOL
    for k in ('ce_loss', 'total_loss', 'tokens', 'moe_aux_loss'):
        assert abs(float(wm[k]) - float(gm[k].detach())) <= LOSS_TOL, k
    assert float(gm['tokens']) == (batch['labels'] >= 0).sum() > 0
    if tcfg.moe is not None:
        assert float(gm['moe_aux_loss'].detach()) > 0
    grads = _by_path(tmodel.params_to_numpy(tadamw.tree_map(
        lambda p: p.grad, params), tcfg))
    ref = _by_path(wg)
    assert grads.keys() == ref.keys()
    for k, w in ref.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(grads[k] - w).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def _ref_step(arch, mode, oc, batch):
    cfg = rconfigs.get(arch, smoke=True)
    opt = radamw.OptConfig(**oc)
    step = jax.jit(rTS.make_train_step(cfg, ryl.YocoConfig(mode=mode),
                                       opt_cfg=opt))
    p = _ref_params(arch)
    return step(p, radamw.init(p, opt), jax.tree.map(jnp.asarray, batch))


def _port_step(arch, mode, oc, batch, params=None):
    cfg = tconfigs.get(arch, smoke=True)
    opt = tadamw.OptConfig(**oc)
    params = port_params(arch) if params is None else params
    return tTS.make_train_step(cfg, tyl.YocoConfig(mode=mode), opt_cfg=opt)(
        params, tadamw.init(params, opt), _torch_batch(batch))


STEP_CASES = (('stablelm-1.6b', 'bf16', 1), ('stablelm-1.6b', 'bf16', 2),
              ('stablelm-1.6b', 'qat', 1), ('stablelm-1.6b', 'w8a8', 1),
              ('qwen2-moe-a2.7b', 'bf16', 1), ('mamba2-780m', 'bf16', 1))


@pytest.mark.parametrize('arch,mode,accum', STEP_CASES)
def test_bf16_train_step_matches_reference(arch, mode, accum):
    lr = 1e-3
    oc = dict(lr=lr, warmup_steps=1, total_steps=10, grad_accum=accum)
    batch = numpy_batch(rconfigs.get(arch, smoke=True), b=4, s=16, seed=3)
    rp, rst, rm = _ref_step(arch, mode, oc, batch)
    tp, tst, tm = _port_step(arch, mode, oc, batch)
    assert abs(float(rm['loss']) - float(tm['loss'])) <= \
        1e-3 * abs(float(rm['loss']))
    assert abs(float(rm['grad_norm']) - float(tm['grad_norm'])) <= \
        5e-3 * float(rm['grad_norm'])
    assert float(rm['lr']) == float(tm['lr'])
    assert int(rst.step) == int(tst.step) == 1
    want = _by_path(rp)
    got = _by_path(tmodel.params_to_numpy(tp, tconfigs.get(arch,
                                                           smoke=True)))
    assert want.keys() == got.keys()
    off = total = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert float(d.max()) <= 2.2 * lr, k
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= 0.03 * total, (off, total)


def _linear_masters(params):
    out = []

    def walk(node, name=''):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, name)
        elif tyl.is_linear_weight(name, node):
            out.append((name, node))
    walk(params)
    return out


@pytest.mark.parametrize('arch,mode', (('stablelm-1.6b', 'w8a8'),
                                       ('stablelm-1.6b', 'qat'),
                                       ('qwen2-moe-a2.7b', 'bf16')))
def test_step_keeps_masters_in_kernel_layout(arch, mode):
    """In place: the masters, their moments and the expert stacks keep
    their tensors and layouts (K-major linears, ``stack_layout`` stacks)
    through two steps."""
    cfg = tconfigs.get(arch, smoke=True)
    opt = tadamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = port_params(arch)
    state = tadamw.init(params, opt)
    before = [t.data_ptr() for t in tadamw.tree_leaves(params)]
    step = tTS.make_train_step(cfg, tyl.YocoConfig(mode=mode), opt_cfg=opt)
    batch = _torch_batch(numpy_batch(cfg, b=2, s=8))
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    assert [t.data_ptr() for t in tadamw.tree_leaves(params)] == before
    assert int(state.step) == 2
    masters = _linear_masters(params)
    assert len(masters) >= 7 * cfg.n_layers // (2 if cfg.moe else 1)
    for tree in (params, state.mu, state.nu):
        for name, w in _linear_masters(tree):
            assert w.dtype == torch.float32
            assert w.t().is_contiguous(), (name, w.stride())
    for p in tadamw.tree_leaves(params):
        assert not p.requires_grad and p.grad is None
    if cfg.moe is not None:
        for tree in (params, state.mu):
            for lp in tree['layers']:
                for name in tmoe.STACKS:
                    if name in lp['moe']:
                        w = lp['moe'][name]
                        assert tmoe.stack_layout(name, w).data_ptr() == \
                            w.data_ptr(), name


def test_cast_params_keeps_strides():
    params = port_params('stablelm-1.6b')
    cast = tTS.cast_params(params)
    for (name, w), (_, c) in zip(_linear_masters(params),
                                 _linear_masters(cast)):
        assert c.dtype == torch.bfloat16 and c.stride() == w.stride(), name
    assert cast['layers'][0]['attn_norm']['scale'].dtype == torch.float32
    assert cast['embed'].dtype == torch.bfloat16


def test_k3_calls_a_training_forward(monkeypatch):
    """K3 (``ops.quantize_rows``) runs once per distinct activation and
    once per weight transpose each forward in qat and w8a8 (the chip's
    exact launch gates scale these to 24 layers), none in bf16, and the
    backward adds none."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.quantize_rows
    monkeypatch.setattr(ops, 'quantize_rows',
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    cfg = tconfigs.get('stablelm-1.6b', smoke=True)
    opt = tadamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _torch_batch(numpy_batch(cfg, b=2, s=8))
    linears = 7 * cfg.n_layers + 1
    activations = 4 * cfg.n_layers + 1
    for mode, want in (('bf16', 0), ('qat', activations + linears),
                       ('w8a8', activations + linears)):
        for accum in (1, 2):
            calls.clear()
            params = port_params('stablelm-1.6b')
            tTS.make_train_step(cfg, tyl.YocoConfig(mode=mode),
                                opt_cfg=tadamw.OptConfig(
                                    **dict(opt.__dict__, grad_accum=accum)))(
                params, tadamw.init(params, opt), batch)
            assert len(calls) == want * accum, (mode, accum, len(calls))
