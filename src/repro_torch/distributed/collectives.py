"""Every collective of the port, over a ``torch.distributed`` group (port
of ``repro/distributed/collectives.py``, plus the serving TP gather of
``repro/models/attention.py::_tp_heads_gather``).

* :func:`heads_all_gather` is the ONE collective of a tensor-parallel
  serving step: each rank holds the attention outputs of its contiguous
  head slice, and a tiled all-gather along the last axis, concatenated in
  rank order, rebuilds the head-major activation before the replicated
  ``wo``. A concatenation of per-head outputs is exact; a sum of partial
  ``wo`` products would reassociate the float reduction, so it is never a
  reduction.
* :func:`compressed_psum` is the reference's int8 error-feedback
  all-reduce: codes against the group's max scale, summed in int32, with
  the residual kept locally. :func:`tree_compressed_psum` maps it over a
  tree, :func:`psum_mean` is the plain mean.
* :func:`gather_objects` moves picklable host objects (a serve's outputs,
  its counters) to every rank, outside the steps.

Each function counts its calls by name in :data:`CALLS`, as the kernel
wrappers count their launches (``kernels/build.py::count``), so a run can
show how many collectives its steps made.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

#: collective name -> calls in this process (a serve reports the change)
CALLS: Dict[str, int] = {'heads_all_gather': 0, 'all_reduce': 0,
                         'gather_objects': 0}


def _count(name: str) -> None:
    CALLS[name] += 1


def heads_all_gather(out_flat: torch.Tensor, group) -> torch.Tensor:
    """(..., N / tp) per rank -> (..., N): every rank's tensor in rank
    order along the last axis (a tiled all-gather, never a reduction)."""
    parts = [torch.empty_like(out_flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, out_flat.contiguous(), group=group)
    _count('heads_all_gather')
    return torch.cat(parts, dim=-1)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    _count('all_reduce')
    return x


def _f32_reciprocal(v: float) -> float:
    """``1 / v`` rounded to f32, as XLA folds a division by a constant."""
    return float(torch.tensor(1.0) / torch.tensor(float(v)))


def compressed_psum(x: torch.Tensor, ef: torch.Tensor,
                    group) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback mean over ``group``: returns (mean, new_ef).

    Each rank quantizes ``x + ef`` against the group's largest absmax
    scale (an all-reduce of one f32), the int8 codes are summed in int32
    (an all-reduce), and the mean is the sum times the shared scale over
    the group size; what the codes missed stays in the rank's ``ef``. The
    scale and the mean take the reference's compiled form: ``/ 127`` and
    ``/ n`` are multiplies by their f32 reciprocals, as XLA folds them,
    and the residual ``val - codes * scale`` is rounded once, as XLA's
    fused multiply-add rounds it (computed in f64, where it is exact)."""
    n = dist.get_world_size(group)
    val = x.to(torch.float32) + ef
    scale = torch.clamp_min(val.abs().amax(), 1e-12) * \
        _f32_reciprocal(127.0)
    scale_max = _all_reduce(scale.reshape(1).clone(), dist.ReduceOp.MAX,
                            group)[0]
    codes = torch.clamp(torch.round(val / scale_max), -127, 127)
    # the int8 payload, summed in int32
    qsum = _all_reduce(codes.to(torch.int8).to(torch.int32),
                       dist.ReduceOp.SUM, group)
    mean = qsum.to(torch.float32) * scale_max * _f32_reciprocal(n)
    f64 = torch.float64
    new_ef = (val.to(f64) - codes.to(f64) * scale_max.to(f64)).to(
        torch.float32)
    return mean, new_ef


def psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The plain f32 mean of ``x`` over the group."""
    out = _all_reduce(x.to(torch.float32).clone(), dist.ReduceOp.SUM, group)
    return out / dist.get_world_size(group)


def tree_compressed_psum(tree: Any, group, ef_tree: Any) -> Tuple[Any, Any]:
    """:func:`compressed_psum` over every leaf of a dict tree, in sorted
    key order (the same order on every rank): returns (means, new_efs)."""
    if isinstance(tree, dict):
        pairs = {k: tree_compressed_psum(tree[k], group, ef_tree[k])
                 for k in sorted(tree)}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return compressed_psum(tree, ef_tree, group)


def gather_objects(obj: Any, group) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    _count('gather_objects')
    return out


def psum_shards(shard, *, xs, efs, steps: int = 1) -> list:
    """A rank job (``distributed/ranks.py``): rank r runs
    :func:`compressed_psum` ``steps`` times on its shard ``xs[r]`` (numpy),
    its error feedback starting at ``efs[r]`` and fed back each step,
    :func:`psum_mean` once and :func:`tree_compressed_psum` once over
    ``dict(a=x, b=dict(c=2 * x))``; returns every rank's (means of each
    step, last ef, plain mean, the tree's means) as numpy, in rank
    order."""
    x = torch.from_numpy(xs[shard.rank]).to(shard.device)
    ef = torch.from_numpy(efs[shard.rank]).to(shard.device)
    means = []
    for _ in range(steps):
        mean, ef = compressed_psum(x, ef, shard.group)
        means.append(mean.cpu().numpy())
    plain = psum_mean(x, shard.group).cpu().numpy()
    tree = dict(a=x, b=dict(c=2 * x))
    zeros = dict(a=torch.zeros_like(x), b=dict(c=torch.zeros_like(x)))
    tmean, _ = tree_compressed_psum(tree, shard.group, zeros)
    return gather_objects((means, ef.cpu().numpy(), plain,
                           (tmean['a'].cpu().numpy(),
                            tmean['b']['c'].cpu().numpy())), shard.group)
