"""The train step (port of ``repro/runtime/train_step.py``):
``make_train_step`` on one device, and the sharded step over a rank mesh
(``sharded_train_step``, the counterpart of ``jit_train_step``, with
``abstract_state`` and ``state_shardings``).

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

The sharded step runs in every rank of a mesh (``launch/mesh.py``; the
ranks of ``distributed/ranks.py``). A rank holds the blocks of the f32
masters and of the AdamW moments under ``sharding.param_specs`` /
``opt_specs``. Each microbatch, every master block is cast to bf16 (the
reference's on-shard cast) and all-gathered over the axes its spec cuts
it on but the step does not compute on (``sharding.compute_specs``: the
'tp' layout keeps a rank's heads, hidden units, vocab and experts over
'model'; 'fsdp2d' only the experts), and the forward runs on the rank's
rows of the microbatch. The gathers' backward lands each gradient on its
master block in f32: reduce-scattered over the axes the tokens are spread
on (each rank's cotangent a part of the sum), sliced over an axis the
tokens are whole on. A leaf whole over an axis the tokens are spread on
is all-reduced over it after the backward, one all-reduce for all leaves
of one set of axes. The loss is the mean over every token of the mesh.
"""

from __future__ import annotations

import torch

from typing import Optional

from repro_torch.core.yoco_linear import DEFAULT_YOCO, YocoConfig
from repro_torch.distributed import collectives, sharding
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


# ----------------------------------------------------------------------------
# abstract trees, specs and the sharded step
# ----------------------------------------------------------------------------
def abstract_state(cfg, opt_cfg: adamw.OptConfig = adamw.OptConfig()):
    """(params, opt_state) on the meta device: the trainer's f32 masters
    (linears K-major) and AdamW state, shapes and layouts only."""
    params = model_mod.k_major_linear_weights(
        model_mod.init_params(None, cfg, device='meta'))
    return params, adamw.init(params, opt_cfg)


def state_shardings(mesh, cfg, params_abs, opt_abs, layout: str = 'tp'):
    """The three spec trees: params, optimizer state, batch."""
    pspecs = sharding.param_specs(params_abs, mesh, layout)
    ospecs = sharding.opt_specs(pspecs, opt_abs)
    bspecs = sharding.batch_specs(cfg, sharding.dp_axes_of(mesh))
    return pspecs, ospecs, bspecs


class _ComputeBlock(torch.autograd.Function):
    """A master block -> the block the step computes on: cast to
    ``dtype`` (bf16 on the wire, as the reference gathers after its cast),
    then all-gathered along each (dim, group, partial) of ``plan``.
    Backward, in f32 and in reverse: a reduce-scatter where ``partial``
    (the ranks' cotangents are parts of the sum), else the rank's slice."""

    @staticmethod
    def forward(ctx, master, dtype, plan):
        ctx.plan = plan
        x = master.to(dtype)
        for dim, group, _ in plan:
            x = collectives.all_gather_dim(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32)
        for dim, group, partial in reversed(ctx.plan):
            if partial:
                g = collectives.reduce_scatter_dim(g, dim, group)
            else:
                g = collectives.slice_dim(g, dim, group)
        return g, None, None


def _gather_plan(spec, cspec, nd: int, mesh, token_axes) -> list:
    """(dim, group, partial) of each gather a leaf needs: every axis of
    its spec the compute spec drops, a dim cut over several axes in one
    gather over their group where all are dropped alike, else one axis at
    a time, its last first; ``partial`` where the tokens are spread over
    the axis."""
    keep = dict(sharding.spec_axes(cspec, nd))
    plan = []
    for dim, axes in sharding.spec_axes(spec, nd):
        kept = keep.get(dim, ())
        drop = [a for a in axes if a not in kept and mesh.axis_size(a) > 1]
        if not drop:
            continue
        partial = [a in token_axes for a in drop]
        if len(drop) == len(axes) and len(set(partial)) == 1:
            # the whole dim in one gather over the axes' group
            plan.append((dim, mesh.group(tuple(drop)), partial[0]))
            continue
        for a in reversed(drop):
            plan.append((dim, mesh.group(a), a in token_axes))
    return plan


def _compute_tree(params, plans):
    """The blocks the forward reads: each f32 master of two or more dims
    cast to bf16 (``cast_params``' rule), each gathered by its plan."""
    def one(p, plan):
        dtype = (torch.bfloat16 if p.dtype == torch.float32 and p.ndim >= 2
                 else p.dtype)
        if not plan:
            return p.to(dtype)
        return _ComputeBlock.apply(p, dtype, plan)
    return adamw.tree_map(one, params, plans)


def _reduce_replicated(grads, specs, mesh, token_axes) -> None:
    """Sum in place, over the token axes each leaf is whole on, the
    gradients that are parts of a sum there: one all-reduce a set of
    axes over the leaves' gradients laid end to end."""
    by_axes = {}
    for g, spec in sharding.leaves_with_specs(grads, specs):
        axes = tuple(a for a in sharding.replicated_axes(spec, mesh)
                     if a in token_axes and mesh.axis_size(a) > 1)
        if axes:
            by_axes.setdefault(axes, []).append(g)
    for axes, gs in by_axes.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        collectives.all_reduce_(flat, mesh.group(axes))
        o = 0
        for g in gs:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()


def rank_rows(batch: dict, mesh, dp_axes, accum: int, i: int) -> dict:
    """This rank's rows of microbatch ``i`` of ``accum``: the microbatch
    is the global rows [i B/A, (i + 1) B/A), and the rank takes its dp
    block of it (the reference's microbatch split kept sharded over dp)."""
    b = next(iter(batch.values())).shape[0]
    dp = mesh.axis_size(dp_axes)
    if b % (accum * dp):
        raise ValueError(f'a global batch of {b} does not split into '
                         f'grad_accum={accum} microbatches over {dp} dp '
                         f'ranks')
    size = b // accum
    per = size // dp
    lo = i * size + mesh.index(dp_axes) * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


def mesh_runtime(mesh, cfg, layout: str = 'tp', remat: str = 'full',
                 **kw) -> ModelRuntime:
    """The reference's runtime of ``jit_train_step``: expert parallelism
    where ``cfg.moe.impl == 'ep'``, batch-sharded activations under 'tp',
    batch x sequence under 'fsdp2d' (``kw``: other fields, e.g. the
    compute dtype)."""
    return ModelRuntime(mesh=mesh, dp_axes=sharding.dp_axes_of(mesh),
                        use_ep=cfg.moe is not None and cfg.moe.impl == 'ep',
                        remat=remat,
                        act_layout='2d' if layout == 'fsdp2d' else 'batch',
                        **kw)


def sharded_train_step(mesh, cfg, yoco: YocoConfig = DEFAULT_YOCO,
                       rt: Optional[ModelRuntime] = None,
                       opt_cfg: adamw.OptConfig = adamw.OptConfig(),
                       layout: str = 'tp', remat: str = 'full'):
    """The reference's ``jit_train_step`` on a rank mesh: returns
    ``(step, (params_abs, opt_abs))``. ``step(params, opt_state, batch)``
    runs in every rank on its blocks (``sharding.shard_tree`` of the
    trainer's state under :func:`state_shardings`) and the whole global
    ``batch`` (each rank reads its rows), writes the blocks in place and
    returns ``(params, opt_state, metrics)``, the metrics replicated: the
    loss the mean of the microbatches' (each the mean over the mesh's
    tokens), the others the last microbatch's. ``rt`` defaults to the
    reference's: expert parallelism where ``cfg.moe.impl == 'ep'``, the
    batch-sharded activations under 'tp', batch x sequence under
    'fsdp2d'."""
    if rt is None:
        rt = mesh_runtime(mesh, cfg, layout, remat)
    params_abs, opt_abs = abstract_state(cfg, opt_cfg)
    pspecs, _, _ = state_shardings(mesh, cfg, params_abs, opt_abs, layout)
    cspecs = sharding.compute_specs(params_abs, pspecs, cfg, mesh,
                                    rt.act_layout, rt.use_ep)

    def loss_of(params, mb):
        """(loss, metrics) of the rank's rows ``mb`` on its blocks, and the
        axes the tokens are spread on."""
        token_axes = model_mod._sharded_rt(
            rt, mb['inputs'].shape[1]).token_axes()
        plans = adamw.tree_map(
            lambda p, sp, cs: _gather_plan(sp, cs, p.ndim, mesh, token_axes),
            params, pspecs, cspecs)
        loss, metrics = model_mod.loss_fn(_compute_tree(params, plans), mb,
                                          cfg, yoco, rt)
        return loss, metrics, token_axes

    def train_step(params, opt_state, batch):
        for p in adamw.tree_leaves(params):
            p.grad = None
            p.requires_grad_(True)
        accum = opt_cfg.grad_accum
        loss_sum = None
        for i in range(accum):
            mb = rank_rows(batch, mesh, rt.dp_axes, accum, i)
            loss, metrics, token_axes = loss_of(params, mb)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss

        def take(p):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
            p.requires_grad_(False)
            return g.mul_(adamw.f32_reciprocal(accum)) if accum > 1 else g
        grads = adamw.tree_map(take, params)
        _reduce_replicated(grads, pspecs, mesh, token_axes)
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             opt_cfg, mesh=mesh,
                                             specs=pspecs)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(
            metrics, **om, loss=adamw.times_reciprocal(loss_sum, accum))

    train_step.loss_of = loss_of
    return train_step, (params_abs, opt_abs)


def _tree_numpy(tree, cfg):
    return model_mod.params_to_numpy(tree, cfg)


def sharded_job(mesh, *, cfg, params=None, batch, layout: str = 'tp',
                mode: str = 'bf16', opt_cfg=None, steps: int = 0,
                remat: str = 'none', seed: int = 0,
                compute_dtype=torch.bfloat16, device=None) -> dict:
    """A mesh job (``distributed/ranks.py::mesh_job``): ``cfg``'s weights
    (``params``, the reference's tree as numpy, or the trainer's seeded
    draw) in the trainer's form, cut into this rank's blocks under
    ``layout``, computing in ``compute_dtype`` on ``device`` (default: the
    rank's; a gloo group also takes the CPU's tensors). With ``steps`` = 0 the
    loss of ``batch`` (numpy, the global batch) on the mesh; else
    ``steps`` sharded AdamW steps on it.
    Returns, on every rank, the losses and metrics, this rank's collective
    calls and bytes, its master and moment bytes, and on rank 0 the whole
    params and moments after the steps (numpy)."""
    from repro_torch.launch import train as train_mod
    from repro_torch import device as device_mod
    dev = device_mod.resolve(device or mesh.device)
    opt_cfg = opt_cfg or adamw.OptConfig()
    yoco = YocoConfig(mode=mode, compute_dtype=compute_dtype)
    if params is None:
        whole, _ = train_mod.init_state(cfg, opt_cfg, seed, dev)
    else:
        whole = model_mod.k_major_linear_weights(
            model_mod.params_from_numpy(params, cfg, dev))
    step, (pabs, oabs) = sharded_train_step(
        mesh, cfg, yoco, mesh_runtime(mesh, cfg, layout, remat,
                                      compute_dtype=compute_dtype),
        opt_cfg=opt_cfg, layout=layout)
    pspecs, ospecs, _ = state_shardings(mesh, cfg, pabs, oabs, layout)
    blocks = sharding.shard_tree(whole, pspecs, mesh)
    del whole
    state = adamw.init(blocks, opt_cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    collectives.reset_counts()
    out = dict(rank=mesh.rank, coords=mesh.coords,
               master_bytes=sharding.nbytes(blocks),
               moment_bytes=sharding.nbytes([state.mu, state.nu]))
    if steps == 0:
        with torch.no_grad():
            loss, metrics, _ = step.loss_of(
                blocks, rank_rows(batch, mesh, sharding.dp_axes_of(mesh),
                                  1, 0))
        out.update(loss=float(loss),
                   metrics={k: float(v) for k, v in metrics.items()})
    else:
        out['losses'], out['metrics'] = [], []
        for _ in range(steps):
            blocks, state, m = step(blocks, state, batch)
            out['losses'].append(float(m['loss']))
            out['metrics'].append({k: float(v) for k, v in m.items()})
    out['calls'] = dict(collectives.CALLS)
    out['bytes'] = dict(collectives.BYTES)
    if steps:
        whole_p = sharding.unshard_tree(blocks, pspecs, mesh)
        whole_m = sharding.unshard_tree(state.mu, pspecs, mesh)
        whole_v = sharding.unshard_tree(state.nu, pspecs, mesh)
        if mesh.rank == 0:
            out.update(params=_tree_numpy(whole_p, cfg),
                       mu=_tree_numpy(whole_m, cfg),
                       nu=_tree_numpy(whole_v, cfg))
    return out
