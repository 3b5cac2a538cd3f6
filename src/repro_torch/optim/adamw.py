"""AdamW with a cosine schedule, global-norm clipping and the optional int8
error-feedback gradient compression (port of ``repro/optim/adamw.py``).

Plain functions on the port's param tree (dicts, per-layer lists, tuples
of tensors): no ``torch.optim`` (its AdamW step differs from the
reference's). The state is a tree of the same shape, so the checkpoint
treats it like the params. :func:`update` writes the params and the
moments IN PLACE, element for element as the reference computes them:
each keeps its tensor, its strides (a K-major linear master stays
K-major) and its memory, and no copy of the whole tree is made.

The reference runs the update under ``jax.jit``, where XLA turns a
division by a constant into a multiplication by the constant's f32
reciprocal (ROADMAP Queue 3): the schedule's two divisions and
``compress_decompress``'s ``/ 127`` are computed in that compiled form
(:func:`times_reciprocal`), and the schedule's tail and the compression's
residual as XLA's fused multiply-adds, so the learning rate is the
reference's bit for bit but for XLA's f32 cosine (an ulp off on about one
step in a hundred) and the compression is. The per-element update agrees
to an ulp or two: XLA fuses some of its products into its adds as well,
and the global norm's sum runs in another order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_accum: int = 1               # microbatch accumulation steps
    compress_grads: bool = False      # int8 error-feedback path


class OptState(NamedTuple):
    step: torch.Tensor                # () int32
    mu: Any                           # first moment (tree)
    nu: Any                           # second moment (tree)
    ef: Any                           # error-feedback residual (or None)


# ----------------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------------
def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in the
    reference's order (dicts by sorted key, sequences in order); None is
    no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on each leaf of ``tree`` and the matching leaves of
    ``rest``, rebuilt in ``tree``'s shape (NamedTuples kept, None left
    None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, '_fields'):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


# ----------------------------------------------------------------------------
# schedule, norms
# ----------------------------------------------------------------------------
def f32_reciprocal(c: float) -> float:
    """``1 / c`` rounded to f32, as XLA folds a division by a constant."""
    return float(torch.tensor(1.0) / torch.tensor(float(c)))


def times_reciprocal(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA compiles it: ``x`` times the
    f32 reciprocal of ``c``."""
    return x * f32_reciprocal(c)


def init(params, cfg: OptConfig) -> OptState:
    """Zero f32 moments shaped (and strided) like each param, on its
    device; step 0 on the first param's device."""
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros(),
                    ef=zeros() if cfg.compress_grads else None)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; ``step``
    a float32 tensor."""
    warm = torch.clamp_max(
        times_reciprocal(step, max(cfg.warmup_steps, 1)), 1.0)
    prog = torch.clamp(times_reciprocal(
        step - cfg.warmup_steps, max(cfg.total_steps - cfg.warmup_steps, 1)),
        0.0, 1.0)
    # the cosine rounded once from f64 (torch's f32 cos is an ulp off
    # XLA's on a sixth of the steps, this one on about one in a hundred:
    # XLA's is not correctly rounded either), then ``min + (1 - min) * 0.5 * (1 + cos)`` as
    # XLA compiles it: the constants folded into one f32, one fused
    # multiply-add (an f64 product of two f32 is exact)
    cos = torch.cos((math.pi * prog).double()).float()
    half = float(torch.tensor(0.5) * torch.tensor(1 - cfg.min_lr_ratio))
    low = float(torch.tensor(cfg.min_lr_ratio))
    tail = ((1.0 + cos).double() * half + low).float()
    return cfg.lr * warm * tail


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The norm of every element of the tree. On a rank mesh (``tree``
    the rank's blocks under ``specs``) every element of the whole leaves
    is counted once: a block replicated over an axis counts on that
    axis's coordinate 0 only, and one all-reduce sums the ranks'
    squares."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in tree_leaves(tree)))
    from repro_torch.distributed import collectives, sharding
    coords = mesh.coords
    total = None
    for x, spec in sharding.leaves_with_specs(tree, specs):
        if any(coords[a] for a in sharding.replicated_axes(spec, mesh)):
            continue
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(tree)[0].device)
    return torch.sqrt(collectives.all_reduce(
        total, mesh.group(mesh.axis_names)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / (gn + 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm ``max_norm`` at most, in f32; the
    norm before)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


# ----------------------------------------------------------------------------
# int8 error-feedback compression
# ----------------------------------------------------------------------------
def compress_decompress(g: torch.Tensor, ef: torch.Tensor, group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 wire format of ``g + ef``: (its dequantized value, the new
    residual). The residual re-enters the next step, so the scheme is
    unbiased over time. ``group``: the ranks whose blocks make up the
    leaf, over which the absmax is the whole leaf's (an all-reduce MAX)."""
    x = g.to(torch.float32) + ef
    amax = torch.amax(torch.abs(x))
    if group is not None:
        from repro_torch.distributed import collectives
        amax = collectives.all_reduce(amax, group,
                                      collectives.dist.ReduceOp.MAX)
    scale = times_reciprocal(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    # XLA fuses the residual's product into its subtraction: one rounding
    # (the f64 product of int8 codes and an f32 scale is exact)
    res = (x.double() - q.double() * scale.double()).to(torch.float32)
    return deq, res


def apply_compression(grads, state: OptState, mesh=None, specs=None
                      ) -> Tuple[Any, OptState]:
    """(the wire values of every gradient, the state with the new
    residuals); on a rank mesh each leaf's scale is its whole leaf's."""
    if mesh is None:
        out = tree_map(compress_decompress, grads, state.ef)
    else:
        from repro_torch.distributed import sharding
        groups = iter([mesh.group(sharding.sharded_axes(sp, mesh))
                       for _, sp in sharding.leaves_with_specs(grads,
                                                               specs)])
        # tree_map visits the leaves in tree_leaves' order
        out = tree_map(lambda g, e: compress_decompress(g, e, next(groups)),
                       _sorted(grads), _sorted(state.ef))
    return _element(out, 0), state._replace(ef=_element(out, 1))


def _sorted(tree):
    """The tree with every dict's keys in sorted order (tree_leaves')."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _element(tree, i: int):
    """Element ``i`` of each (wire, residual) pair in a tree of pairs."""
    if isinstance(tree, dict):
        return {k: _element(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_element(v, i) for v in tree]
    return tree[i]


# ----------------------------------------------------------------------------
# update
# ----------------------------------------------------------------------------
@torch.no_grad()
def update(params, grads, state: OptState, cfg: OptConfig, mesh=None,
           specs=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step: optional compression, clipping to the global norm,
    then per leaf ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2)
    g g``, and ``p -= lr (mu / (bc1 (sqrt(nu / bc2) + eps)) + wd p)``
    (the bias-corrected step in the form XLA compiles the reference's
    ``mhat / (sqrt(vhat) + eps)`` into), the decay on matrices only
    (``p.ndim >= 2``). ``params``, ``mu`` and ``nu`` are written in place
    (f32 masters: the update's f32 result is the param). Returns
    (params, state, dict(grad_norm, lr)). On a rank mesh (the rank's
    blocks under ``specs``) the update runs on the blocks as they are and
    the global norm and the compression's scales are the whole leaves'."""
    if cfg.compress_grads:
        grads, state = apply_compression(grads, state, mesh, specs)
    gn = global_norm(grads, mesh, specs)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    b1, b2 = cfg.betas
    step_f = step.to(torch.float32)
    lr = schedule(step_f, cfg)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), step_f)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), step_f)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        del g
        delta = torch.div(v, bc2).sqrt_().add_(cfg.eps).mul_(bc1)
        delta = torch.div(m, delta, out=delta)
        if cfg.weight_decay and p.ndim >= 2:     # decay matrices only
            delta.add_(p.to(torch.float32) * cfg.weight_decay)
        p.sub_((lr * delta).to(p.dtype))
        del delta
    return params, OptState(step=step, mu=state.mu, nu=state.nu,
                            ef=state.ef), dict(grad_norm=gn, lr=lr)


def compression_job(mesh, *, grads: dict, efs: dict, specs: dict) -> dict:
    """A mesh job (``distributed/ranks.py::mesh_job``): the rank's blocks
    of whole f32 leaves ``grads`` and ``efs`` (numpy, by name) under
    ``specs`` (spec tuples, by name) through :func:`apply_compression` on
    the mesh, then gathered whole. Returns (wire values, residuals) as
    numpy, by name."""
    from repro_torch import device as device_mod
    from repro_torch.distributed import sharding
    dev = device_mod.resolve(mesh.device)
    sp = {k: sharding.P(*v) for k, v in specs.items()}

    def blocks(tree):
        return {k: sharding.block(torch.from_numpy(v).to(dev), sp[k], mesh)
                for k, v in tree.items()}
    state = OptState(step=torch.zeros((), dtype=torch.int32), mu=None,
                     nu=None, ef=blocks(efs))
    wire, state = apply_compression(blocks(grads), state, mesh, sp)
    out = {}
    for name, tree in (('wire', wire), ('ef', state.ef)):
        whole = sharding.unshard_tree(tree, sp, mesh)
        out[name] = {k: v.cpu().numpy() for k, v in whole.items()}
    return out
