"""Remat (``ModelRuntime.remat``, the reference's ``_maybe_remat``): each
layer's body under non-reentrant ``torch.utils.checkpoint``, 'full'
saving nothing and 'dots' saving the matrix products (the counterpart of
``dots_with_no_batch_dims_saveable``). On the CPU the loss and every
gradient are bit-equal to no remat, in bf16, w8a8 and analog_sim (whose
noise is redrawn equal when a layer is recomputed) and on the MoE, MLA
and SSM families; autograd keeps fewer bytes than without remat, 'full'
runs every matrix product of a layer again in the backward and 'dots'
none (counted at dispatch), and 'full' runs each layer's K3 calls
again."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.data import synthetic
from repro_torch.kernels import quantize as kq
from repro_torch.launch import train as ttrain
from repro_torch.models import model as M
from repro_torch.models.model import ModelRuntime
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as TS

CASES = (('stablelm-1.6b', 'bf16'), ('stablelm-1.6b', 'w8a8'),
         ('stablelm-1.6b', 'analog_sim'), ('qwen2-moe-a2.7b', 'bf16'),
         ('deepseek-v3-671b', 'bf16'), ('mamba2-780m', 'bf16'))


class _CountMatmuls(TorchDispatchMode):
    """Counts the matrix products that run (a product remat 'dots' saved
    is answered from its cache and never reaches this mode)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads(arch, mode, remat):
    """(loss, every master's gradient, bytes autograd saved for the
    backward outside a checkpoint's own store, matrix products the
    backward ran)."""
    cfg = configs.get(arch, smoke=True)
    params, _ = ttrain.init_state(cfg, adamw.OptConfig(), 0, 'cpu')
    batch = synthetic.make_batch(synthetic.for_arch(cfg, global_batch=2,
                                                    seq_len=16), 0)
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = M.loss_fn(TS.cast_params(params), batch, cfg,
                            YocoConfig(mode=mode), ModelRuntime(remat=remat))
    with _CountMatmuls() as mm:
        loss.backward()
    return (loss.detach(), [p.grad for p in adamw.tree_leaves(params)],
            saved[0], mm.n)


@pytest.mark.parametrize('arch,mode', CASES)
def test_remat_is_bit_equal_to_none(arch, mode):
    want, wg, none_bytes, none_mm = _grads(arch, mode, 'none')
    kept, mms = {}, {}
    for remat in ('full', 'dots'):
        got, gg, kept[remat], mms[remat] = _grads(arch, mode, remat)
        assert torch.equal(got, want), remat
        assert len(gg) == len(wg)
        for a, b in zip(gg, wg):
            assert torch.equal(a, b), remat
    # both keep only each layer's input outside their store; 'full'
    # recomputes every product, 'dots' none
    assert kept['full'] == kept['dots'] < none_bytes, (kept, none_bytes)
    assert mms['dots'] == none_mm < mms['full'], (mms, none_mm)


def test_full_remat_recomputes_each_layer(monkeypatch):
    calls = []
    real = kq.quantize_rows

    def counted(x):
        calls.append(x.shape)
        return real(x)
    monkeypatch.setattr(kq, 'quantize_rows', counted)
    n = {}
    for remat in ('none', 'full'):
        calls.clear()
        _grads('stablelm-1.6b', 'w8a8', remat)
        n[remat] = len(calls)
    cfg = configs.get('stablelm-1.6b', smoke=True)
    # a layer quantizes 4 activations and 7 weight transposes; the
    # lm_head (1 + 1) is no layer's
    per_layer = 4 + 7
    assert n['full'] - n['none'] == per_layer * cfg.n_layers, n


def test_unknown_remat_is_refused():
    with pytest.raises(ValueError, match='remat must be'):
        _grads('stablelm-1.6b', 'bf16', 'offload')
