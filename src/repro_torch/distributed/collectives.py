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
* The sharded train step's collectives (``runtime/train_step.py``), each
  over a tensor dim as the reference's ``jax.lax`` collectives are, and
  each crossed by autograd as a ``torch.autograd.Function`` with its
  explicit transpose: :func:`gather` (all-gather; backward a
  reduce-scatter where each rank's cotangent is its part of a sum, the
  rank's slice where every rank holds the whole cotangent), :func:`split`
  (the rank's slice of a replicated tensor; backward an all-gather),
  :func:`reduce_sum` (all-reduce; backward the identity, each rank's
  input a part of the replicated sum), :func:`copy_in` (the identity;
  backward an all-reduce, Megatron's pair of operators) and
  :func:`all_to_all` (backward the inverse all_to_all). The plain
  :func:`all_gather_dim`, :func:`reduce_scatter_dim`, :func:`all_reduce`
  and :func:`all_to_all_dim` run the wire.

Each function counts its calls by name in :data:`CALLS`, as the kernel
wrappers count their launches (``kernels/build.py::count``), and the
training collectives their bytes in :data:`BYTES` (the whole tensor a
call gathers, reduces or exchanges, as this rank sees it), so a run can
show how many collectives its steps made and what they moved. Groups of
one rank (None) make no call and count nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

#: collective name -> calls in this process (a serve reports the change)
CALLS: Dict[str, int] = {'heads_all_gather': 0, 'all_reduce': 0,
                         'gather_objects': 0, 'all_gather': 0,
                         'reduce_scatter': 0, 'all_to_all': 0}
#: the collectives a serve reports (the training ones never run there)
SERVING = ('heads_all_gather', 'all_reduce', 'gather_objects')
#: collective name -> bytes of the tensors the training collectives moved
BYTES: Dict[str, int] = {'all_gather': 0, 'reduce_scatter': 0,
                         'all_reduce': 0, 'all_to_all': 0}


#: (collective name, group) -> the bytes of :data:`BYTES` over that group
#: (a dry run maps each group to its mesh axes, ``launch/dryrun.py``)
GROUP_BYTES: Dict[Tuple[str, Any], int] = {}


def _count(name: str, nbytes: int = 0, group=None) -> None:
    CALLS[name] += 1
    if name in BYTES:
        BYTES[name] += int(nbytes)
        key = (name, group)
        GROUP_BYTES[key] = GROUP_BYTES.get(key, 0) + int(nbytes)


def reset_counts() -> None:
    for d in (CALLS, BYTES):
        for k in d:
            d[k] = 0
    GROUP_BYTES.clear()


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
    _count('all_reduce', x.numel() * x.element_size(), group)
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


# ----------------------------------------------------------------------------
# the sharded train step's collectives
# ----------------------------------------------------------------------------
# gloo takes CUDA tensors in each of them (checked on the H100 with torch
# 2.11: all-gather, reduce-scatter, all_to_all and all-reduce, bf16, f32
# and int32, on the world and on a subgroup), so ranks sharing one card
# run them as they are.
# the tensor forms (renamed ``*_single`` in torch 2.13, the old names
# deprecated there)
_ALL_GATHER = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, 'reduce_scatter_single', None) \
    or dist.reduce_scatter_tensor


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (a tiled all-gather), laid out in memory as ``x``."""
    if group is None:
        return x
    from repro_torch.distributed.sharding import with_layout
    lead = x.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = lead.new_empty((n * lead.shape[0],) + tuple(lead.shape[1:]))
    _ALL_GATHER(out, lead, group=group)
    _count('all_gather', _nbytes(out), group)
    return with_layout(out.movedim(0, dim), x)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's 1/n along ``dim``
    (a tiled reduce-scatter), laid out in memory as ``x``."""
    if group is None:
        return x
    from repro_torch.distributed.sharding import with_layout
    n = dist.get_world_size(group)
    _count('reduce_scatter', _nbytes(x), group)
    lead = x.movedim(dim, 0).contiguous()
    out = lead.new_empty((lead.shape[0] // n,) + tuple(lead.shape[1:]))
    _REDUCE_SCATTER(out, lead, group=group)
    return with_layout(out.movedim(0, dim), x)


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """The group's reduction (default the sum) of ``x``, a new tensor."""
    if group is None:
        return x
    return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                       op or dist.ReduceOp.SUM, group)


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """:func:`all_reduce` in place on a contiguous ``x``."""
    if group is None:
        return x
    return _all_reduce(x, op or dist.ReduceOp.SUM, group)


def all_to_all_dim(x: torch.Tensor, split_dim: int, concat_dim: int,
                   group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    x cut in n along ``split_dim``, piece j sent to group rank j, the
    pieces received concatenated along ``concat_dim`` in rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    lead = x.movedim(split_dim, 0).contiguous()
    _count('all_to_all', _nbytes(lead), group)
    recv = torch.empty_like(lead)
    dist.all_to_all_single(recv, lead, group=group)
    pieces = recv.chunk(n)
    return torch.cat([p.movedim(0, split_dim) for p in pieces],
                     dim=concat_dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, \
                None
        return _slice(g, ctx.dim, ctx.group), None, None, None


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim)[r]


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all_dim(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all_dim(g, concat_dim, split_dim, ctx.group), None, \
            None, None


def gather(x: torch.Tensor, dim: int, group, partial: bool = True):
    """All-gather along ``dim``. Backward: with ``partial`` each rank's
    cotangent is its part of the whole (the ranks computed on different
    tokens), reduce-scattered; else every rank holds the whole cotangent
    (the same tokens), and takes its slice."""
    if group is None:
        return x
    return _Gather.apply(x, dim, group, partial)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n along ``dim`` of a tensor every rank holds whole;
    backward all-gathers the slices' cotangents."""
    if group is None:
        return x
    return _Split.apply(x, dim, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of each rank's part; backward the identity (the
    sum is replicated, and each part's cotangent is the sum's)."""
    if group is None:
        return x
    return _ReduceSum.apply(x, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """The identity on a replicated tensor that each rank then uses for
    its own part of the work; backward all-reduces the parts'
    cotangents."""
    if group is None:
        return x
    return _CopyIn.apply(x, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group):
    """:func:`all_to_all_dim` under autograd (backward: the inverse
    all_to_all)."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def slice_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n of ``x`` along ``dim`` (no communication)."""
    if group is None:
        return x
    return _slice(x, dim, group)
