"""The train step (port of ``repro/runtime/train_step.py``'s
``make_train_step``, without the mesh: one device).

``make_train_step(cfg, yoco, rt, opt_cfg)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``:

* every f32 leaf with ``ndim >= 2`` is cast to bf16 before the model reads
  it (:func:`cast_params`, the reference's on-shard cast), so the whole
  forward runs on bf16 weights whatever the compute dtype; the cast keeps
  each tensor's strides, so a K-major linear master gives a K-major bf16
  weight that kernel K3 reads in place;
* the gradients land on the f32 masters (``.grad``, laid out as each
  master is), summed in f32 over ``opt_cfg.grad_accum`` microbatches (the
  batch's leading dim split in A equal parts) and divided by A; the loss is
  the microbatches' mean, the other metrics the last microbatch's (both
  divisions by A in the reference's compiled form,
  :func:`repro_torch.optim.adamw.times_reciprocal`);
* :func:`repro_torch.optim.adamw.update` then writes the masters and the
  moments in place, so the step returns the tensors it was given.
"""

from __future__ import annotations

import torch

from repro_torch.core.yoco_linear import DEFAULT_YOCO, YocoConfig
from repro_torch.models import model as model_mod
from repro_torch.models.model import DEFAULT_RT, ModelRuntime
from repro_torch.optim import adamw


def cast_params(params):
    """Every f32 leaf of two or more dims as bf16 (strides kept: ``.to``
    preserves a dense tensor's layout), the rest as it is."""
    return adamw.tree_map(
        lambda p: p.to(torch.bfloat16)
        if p.dtype == torch.float32 and p.ndim >= 2 else p, params)


def _microbatches(batch: dict, accum: int) -> list:
    """The batch's leading dim split into ``accum`` equal parts."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f'grad_accum={accum} does not divide the batch '
                         f'of {b}')
    size = b // accum
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(accum)]


def make_train_step(cfg, yoco: YocoConfig = DEFAULT_YOCO,
                    rt: ModelRuntime = DEFAULT_RT,
                    opt_cfg: adamw.OptConfig = adamw.OptConfig()):
    """The gradient-accumulated AdamW step. ``params`` are f32 masters;
    ``batch`` holds tensors on their device (``inputs``, ``labels``)."""

    def train_step(params, opt_state, batch):
        for p in adamw.tree_leaves(params):
            p.grad = None
            p.requires_grad_(True)
        accum = opt_cfg.grad_accum
        loss_sum = None
        for mb in _microbatches(batch, accum):
            loss, metrics = model_mod.loss_fn(cast_params(params), mb, cfg,
                                              yoco, rt)
            loss.backward()         # f32 sums in each master's .grad
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss

        def take(p):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
            p.requires_grad_(False)
            return g.mul_(adamw.f32_reciprocal(accum)) if accum > 1 else g
        grads = adamw.tree_map(take, params)
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(
            metrics, **om, loss=adamw.times_reciprocal(loss_sum, accum))

    return train_step
