"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): a token-choice
top-k router and the dense execution, every expert on every token, mixed
by the router's gates (the reference's ``moe_dense``, which it runs on one
device whatever ``impl`` says), and expert parallelism (:func:`moe_ep`):
the capacity-buffered dispatch (:func:`dispatch_combine`, with its
capacity drops) with two ``all_to_all``s over a rank mesh's 'model' axis,
each rank running its block of the expert stacks on every peer's tokens.

Expert stacks keep the reference's shapes, ``w_gate``/``w_up``/``w_in``
(E, d, f) and ``w_down``/``w_out`` (E, f, d), with E the padded
``stack_size`` (zero dummy experts the router never addresses). The input
stacks are stored as a view of a (d, E, f)-contiguous tensor
(:func:`stack_layout`, made once at load), so :func:`moe_dense` runs each
as ONE (T, d) x (d, E·f) product and never broadcasts x to (E, T, d); the
output stacks stay (E, f, d)-contiguous, one (T, E·f) x (E·f, d) product
with the gates folded into its left operand. Shapes are fixed by (T, E):
no host read, no per-expert loop over routed counts. The expert products
are float in every mode (the reference's ``quantize_tree`` skips expert
stacks), in the compute dtype; the shared experts are ordinary linears.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import yoco_linear
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.models.layers import dense_init, keep

#: expert stack names; the first three are (E, d, f) input stacks
IN_STACKS = ('w_gate', 'w_up', 'w_in')
STACKS = IN_STACKS + ('w_down', 'w_out')
#: f32 bytes an expert-stack draw may hold at once (init_moe's slices)
DRAW_BYTES = 1 << 30


def is_expert_stack(name: str, leaf) -> bool:
    """A float (E, ., .) expert stack, by parameter name as in the
    reference (the dense MLP's weights of the same names are 2-D)."""
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.ndim == 3 and name in STACKS)


def stack_layout(name: str, w: torch.Tensor) -> torch.Tensor:
    """An expert stack in the layout :func:`moe_dense` reads: an input
    stack's (E, d, f) values as a view of a (d, E, f)-contiguous tensor
    (one (d, E·f) matrix), an output stack (E, f, d)-contiguous. A stack
    already stored so is returned uncopied."""
    if name in IN_STACKS:
        return w.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    return w.contiguous()


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def _draw_stack(gen, e_stack: int, n_experts: int, d_in: int, d_out: int, *,
                device, name: str, leaf) -> torch.Tensor:
    """One expert stack, N(0, 1/d_in), its dummy experts zero: drawn in
    slices of experts of at most DRAW_BYTES of f32 each, every slice passed
    through ``leaf(name, slice)`` before the next draw."""
    per = max(1, DRAW_BYTES // (4 * d_in * d_out))
    col = name in IN_STACKS
    out = None
    for e0 in range(0, n_experts, per):
        e1 = min(e0 + per, n_experts)
        w = leaf(name, torch.randn((e1 - e0, d_in, d_out), generator=gen,
                                   dtype=torch.float32, device=device)
                 .mul_(1.0 / math.sqrt(d_in)))
        if out is None:
            shape = ((d_in, e_stack, d_out) if col
                     else (e_stack, d_in, d_out))
            out = torch.zeros(shape, dtype=w.dtype, device=device)
        (out[:, e0:e1] if col else out[e0:e1]).copy_(
            w.permute(1, 0, 2) if col else w)
        del w
    return out.permute(1, 0, 2) if col else out


def init_moe(gen: torch.Generator, cfg, *, device, leaf=keep) -> dict:
    """The router (d, n_experts) f32, unpadded; the expert stacks padded to
    ``stack_size`` with zero dummy experts, in :func:`stack_layout`; the
    shared experts fused into one FFN of ``d_ff_shared``. ``leaf(name,
    w)`` takes each f32 linear weight and each slice of an expert stack
    right after its draw (never the router, which stays f32 as the
    reference reads it)."""
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_ff_expert, mo.stack_size
    wide = cfg.mlp_type in ('swiglu', 'geglu')
    p = dict(router=dense_init(gen, d, mo.n_experts, device=device,
                               scale=0.02))
    stacks = ((('w_gate', d, f), ('w_up', d, f), ('w_down', f, d)) if wide
              else (('w_in', d, f), ('w_out', f, d)))
    for name, d_in, d_out in stacks:
        p[name] = _draw_stack(gen, e, mo.n_experts, d_in, d_out,
                              device=device, name=name, leaf=leaf)
    if mo.d_ff_shared:
        fs = mo.d_ff_shared
        names = ((('sh_gate', d, fs), ('sh_up', d, fs), ('sh_down', fs, d))
                 if wide else (('sh_in', d, fs), ('sh_out', fs, d)))
        for name, d_in, d_out in names:
            p[name] = leaf(name, dense_init(gen, d_in, d_out,
                                            device=device))
    return p


# ----------------------------------------------------------------------------
# expert and shared FFNs
# ----------------------------------------------------------------------------
def _act(cfg):
    if cfg.mlp_type == 'swiglu':
        return F.silu
    return lambda t: F.gelu(t, approximate='tanh')


def _expert_ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (E, C, d) through per-expert weights (E, d, f)/(E, f, d), in
    x's dtype (the capacity buffer's product)."""
    act = _act(cfg)
    if 'w_gate' in p:
        g = torch.matmul(x, p['w_gate'].to(x.dtype))
        u = torch.matmul(x, p['w_up'].to(x.dtype))
        return torch.matmul(act(g) * u, p['w_down'].to(x.dtype))
    h = act(torch.matmul(x, p['w_in'].to(x.dtype)))
    return torch.matmul(h, p['w_out'].to(x.dtype))


def _shared_ffn(p: dict, x: torch.Tensor, cfg,
                yoco: YocoConfig) -> torch.Tensor:
    """The shared experts, one FFN of ordinary linears (gate and up share
    one quantization of x in w8a8)."""
    act = _act(cfg)
    if 'sh_gate' in p:
        g, u = yoco_linear.linears(x, [p['sh_gate'], p['sh_up']], cfg=yoco)
        return yoco_linear.linear(act(g) * u, p['sh_down'], cfg=yoco)
    h = act(yoco_linear.linear(x, p['sh_in'], cfg=yoco))
    return yoco_linear.linear(h, p['sh_out'], cfg=yoco)


def _layout_error(name: str) -> ValueError:
    return ValueError(
        f'expert stack {name} is not stored as moe_dense reads it (input '
        f'stacks a view of a (d, E, f)-contiguous tensor, output stacks '
        f'(E, f, d)-contiguous): store it once with models.moe.'
        f'stack_layout (init_params and params_from_numpy do)')


def _slice_experts(p: dict, name: str, e0: int, e1: int,
                   dtype) -> torch.Tensor:
    """Experts [e0, e1) of stack ``name`` as one matrix in ``dtype``:
    (d, n·f) of an input stack, (n·f, d) of an output stack. A view when
    the stack is stored in ``dtype`` and the slice is whole."""
    w = p[name]
    if name in IN_STACKS:
        cols = w.permute(1, 0, 2)
        if not cols.is_contiguous():
            raise _layout_error(name)
        return cols[:, e0:e1].to(dtype).reshape(cols.shape[0], -1)
    if not w.is_contiguous():
        raise _layout_error(name)
    return w[e0:e1].to(dtype).reshape(-1, w.shape[-1])


def _mixed_experts(p: dict, xt: torch.Tensor, mix: torch.Tensor,
                   cfg) -> torch.Tensor:
    """``sum_e mix[:, e] * expert_e(xt)`` over the whole stack: (T, d).
    Each input stack is one product with xt, the gates scale each expert's
    hidden units, and one product with the output stack sums the experts.
    Stacks stored in another dtype than xt's (an f32 check of bf16 weights)
    are cast in slices of experts of at most DRAW_BYTES each."""
    act = _act(cfg)
    wide = 'w_gate' in p
    names = ('w_gate', 'w_up', 'w_down') if wide else ('w_in', 'w_out')
    t, e_all = mix.shape
    first = p[names[0]]
    d, f = first.shape[1], first.shape[2]
    per = (e_all if first.dtype == xt.dtype
           else max(1, DRAW_BYTES // (d * f * xt.element_size())))
    y = None
    for e0 in range(0, e_all, per):
        e1 = min(e0 + per, e_all)
        hs = [xt @ _slice_experts(p, n, e0, e1, xt.dtype)
              for n in names[:-1]]
        h = act(hs[0]) * hs[1] if wide else act(hs[0])
        h = (h.view(t, e1 - e0, f) * mix[:, e0:e1, None]).view(t, -1)
        part = h @ _slice_experts(p, names[-1], e0, e1, xt.dtype)
        y = part if y is None else y + part
    return y


# ----------------------------------------------------------------------------
# router
# ----------------------------------------------------------------------------
def _top_k(p: dict, x: torch.Tensor, cfg):
    """(router probabilities (T, E) f32, the top-k gates renormalized in
    f32 and cast to x's dtype, their expert ids int64)."""
    logits = x.to(torch.float32) @ p['router'].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    gates, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)  # renormalize
    return probs, gates.to(x.dtype), ids


def _router_metrics(probs: torch.Tensor, ids: torch.Tensor, cfg,
                    group=None) -> dict:
    """The Switch-style load-balance loss ``E * sum_e f_e * p_e`` (f_e:
    the fraction of tokens whose top-1 is e) and the router's entropy.
    With a ``group`` (the ranks this one's tokens are a part of, equal
    shares each) the means are over every token of the group, as one
    device computes them over the whole batch."""
    e = cfg.moe.n_experts
    onehot = (ids[:, :1] == torch.arange(e, device=ids.device)).to(
        torch.float32)                                      # top-1, no sync
    ent = -torch.sum(probs * torch.log(probs + 1e-9), dim=-1)
    if group is None:
        me = torch.mean(probs, dim=0)                       # mean router prob
        ce = torch.mean(onehot, dim=0)                      # fraction routed
        return dict(aux_loss=e * torch.sum(me * ce),
                    router_entropy=torch.mean(ent))
    from repro_torch.distributed import collectives
    n = probs.shape[0] * collectives.dist.get_world_size(group)
    sums = collectives.reduce_sum(torch.cat([
        probs.sum(dim=0), onehot.sum(dim=0), ent.sum()[None]]), group)
    me, ce = sums[:e] / n, sums[e:2 * e] / n
    return dict(aux_loss=e * torch.sum(me * ce), router_entropy=sums[-1] / n)


def route(p: dict, x: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """x: (T, d) -> (gates (T, k) in x's dtype, expert_ids (T, k) int32,
    metrics). f32 router logits, softmax, top-k, the top-k gates
    renormalized in f32; the load-balance loss and the router's entropy
    as metrics."""
    probs, gates, ids = _top_k(p, x, cfg)
    return gates, ids.to(torch.int32), _router_metrics(probs, ids, cfg)


# ----------------------------------------------------------------------------
# dense execution
# ----------------------------------------------------------------------------
def moe_dense(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig,
              with_metrics: bool = True, group=None
              ) -> Tuple[torch.Tensor, dict]:
    """Exact combine, no capacity drops. x: (B, S, d). Every expert of the
    stack runs on every token; the (T, stack) mix holds each token's gates
    at its experts (zero elsewhere, the dummies included), in x's dtype;
    the shared FFN is added after the combine. Each token's output reads
    only its own row. ``with_metrics=False`` skips the router's metrics
    (empty dict), which serving never reads, as the compiled reference
    drops them. ``group``: the ranks whose tokens the router's metrics
    average over (a rank mesh's token axes)."""
    mo = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs, gates, ids = _top_k(p, xt, cfg)
    mix = torch.zeros((xt.shape[0], mo.stack_size), dtype=x.dtype,
                      device=x.device)
    mix.scatter_add_(1, ids, gates)
    y = _mixed_experts(p, xt, mix, cfg)
    if mo.d_ff_shared:
        y = y + _shared_ffn(p, xt, cfg, yoco)
    metrics = _router_metrics(probs, ids, cfg, group) if with_metrics else {}
    return y.reshape(b, s, d), metrics


# ----------------------------------------------------------------------------
# sort-based capacity dispatch (the expert-parallel path's, single host)
# ----------------------------------------------------------------------------
def _positions_in_expert(flat_ids: torch.Tensor,
                         n_experts: int) -> torch.Tensor:
    """For each routing slot, its arrival index within its expert's queue
    (a stable sort and a running max: no (T·k, E) one-hots)."""
    del n_experts
    tk = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    ar = torch.arange(tk, dtype=torch.int32, device=flat_ids.device)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=flat_ids.device),
                          sorted_ids[1:] != sorted_ids[:-1]])
    starts = torch.where(is_start, ar, torch.zeros_like(ar))
    starts = torch.cummax(starts, dim=0).values
    out = torch.zeros((tk,), dtype=torch.int32, device=flat_ids.device)
    out[order] = ar - starts
    return out


def dispatch_combine(p: dict, xt: torch.Tensor, cfg, yoco: YocoConfig,
                     capacity: int, expert_fn=None,
                     n_buckets: Optional[int] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """Capacity-buffered MoE on (T, d) tokens against the expert stack in
    ``p``: each routing slot past its expert's ``capacity`` is dropped
    (``drop_fraction`` in the metrics). ``expert_fn(buf (E', C, d))``
    defaults to the local FFN; ``n_buckets`` >= n_experts pads the
    dispatch buffer."""
    mo = cfg.moe
    nb = n_buckets or mo.n_experts
    t, d = xt.shape
    k = mo.top_k
    gates, ids, metrics = route(p, xt, cfg)
    flat_ids = ids.reshape(-1)                              # (T*k,)
    pos = _positions_in_expert(flat_ids, mo.n_experts)      # (T*k,)
    keep_ = pos < capacity
    slots = nb * capacity
    dest = torch.where(keep_, flat_ids * capacity + pos,
                       torch.full_like(pos, slots)).to(torch.int64)
    x_rep = torch.repeat_interleave(xt, k, dim=0)           # (T*k, d)
    # one spare row takes the dropped slots' writes
    buf = torch.zeros((slots + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = x_rep
    buf = buf[:slots].reshape(nb, capacity, d)
    y_buf = (expert_fn or (lambda bb: _expert_ffn(p, bb, cfg)))(buf)
    y_flat = y_buf.reshape(-1, d)
    y_rep = torch.where(keep_[:, None],
                        y_flat[torch.clamp(dest, 0, slots - 1)],
                        torch.zeros((), dtype=y_flat.dtype,
                                    device=y_flat.device))
    y = (y_rep.reshape(t, k, d)
         * gates[..., None].to(y_rep.dtype)).sum(dim=1)
    metrics['drop_fraction'] = 1.0 - torch.mean(keep_.to(torch.float32))
    if mo.d_ff_shared:
        y = y + _shared_ffn(p, xt, cfg, yoco).to(y.dtype)
    return y.to(xt.dtype), metrics


# ----------------------------------------------------------------------------
# expert-parallel execution (all_to_all over the mesh's 'model' axis)
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class EPContext:
    """``mesh``: the rank mesh (``launch/mesh.py::RankMesh``); ``dp_axes``
    the batch axes; ``ep_axis`` the experts' axis. ``seq_split``: the
    tokens arrive as this rank's 1/ep of the sequence (the '2d' layout),
    else replicated over ``ep_axis`` (the 'tp' layout)."""
    mesh: Any
    dp_axes: tuple
    ep_axis: str = 'model'
    seq_split: bool = False


def _copy_in(w, group):
    """``collectives.copy_in`` on a leaf, a ``QuantizedWeight``'s codes and
    scales alike (a served shared expert's int8 weights)."""
    from repro_torch.distributed import collectives
    if isinstance(w, yoco_linear.QuantizedWeight):
        return yoco_linear.QuantizedWeight(
            *(collectives.copy_in(t, group) for t in w))
    return collectives.copy_in(w, group)


def moe_ep(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, ctx: EPContext,
           ) -> Tuple[torch.Tensor, dict]:
    """Expert-parallel MoE (the reference's shard_map body). x: this
    rank's (B, S, d) tokens; the expert stacks in ``p``: its block of
    stack_size / ep experts (the 'model' block of their specs).

    Where the whole sequence splits over the EP axis (S % ep == 0, S > 1)
    each (dp, ep) shard routes its 1/ep of it: tokens replicated over ep
    are split here (``collectives.split``) and gathered back after; the
    non-expert leaves (router, shared experts) then enter through
    ``copy_in``, their shards' cotangents summed. A shard builds the
    (stack_size, C, d) dispatch buffer at capacity ``max(int(t_loc · top_k
    · capacity_factor / n_experts), top_k)``, t_loc its token count,
    all_to_alls it so each rank holds its experts' slots from every peer,
    runs its experts, all_to_alls back and combines; routing slots past
    capacity drop. The scalar metrics (the aux loss among them) are each
    shard's, averaged over the shards (the reference's pmean over the EP
    axis, then the dp axes), not global statistics."""
    from repro_torch.distributed import collectives
    mo = cfg.moe
    mesh = ctx.mesh
    ep = mesh.axis_size(ctx.ep_axis)
    e_pad = mo.stack_size
    assert e_pad % ep == 0, (
        f'expert stack {e_pad} must divide EP={ep}: set '
        f'MoEConfig.pad_experts_to (in-step padding would force a full '
        f'expert all-gather per layer — §Perf qwen2-moe iter 2)')
    b, s, d = x.shape
    dp_size = mesh.axis_size(ctx.dp_axes)
    s_whole = s * ep if ctx.seq_split else s
    seq_sharded = s_whole % ep == 0 and s_whole > 1
    shards = dp_size * (ep if seq_sharded else 1)
    t_loc = max(b * dp_size * s_whole // shards, 1)
    capacity = max(int(t_loc * mo.top_k * mo.capacity_factor
                       / mo.n_experts), mo.top_k)
    group = mesh.group(ctx.ep_axis)
    x_l, pp = x, p
    enter = seq_sharded and not ctx.seq_split
    if enter:
        x_l = collectives.split(x, 1, group)
        pp = {k: v if k in STACKS else _copy_in(v, group)
              for k, v in p.items()}
    elif not seq_sharded and group is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            'moe_ep with tokens replicated over the EP axis (S % ep != 0 '
            'or S == 1: the decode-time layout) runs every token on every '
            'EP rank; training needs the sequence split over it')

    def expert_fn(buf):                     # (E_pad, C, d) local
        recv = collectives.all_to_all(buf, 0, 1, group)   # (E_loc, ep*C, d)
        y = _expert_ffn(pp, recv, cfg)
        return collectives.all_to_all(y, 1, 0, group)

    y, m = dispatch_combine(pp, x_l.reshape(-1, d), cfg, yoco, capacity,
                            expert_fn, n_buckets=e_pad)
    y = y.reshape(x_l.shape)
    if enter:
        y = collectives.gather(y, 1, group, partial=False)
    keys = sorted(m)
    total = collectives.reduce_sum(
        torch.stack([m[k].to(torch.float32) for k in keys]),
        mesh.group(tuple(ctx.dp_axes) + (ctx.ep_axis,)))
    n = dp_size * ep
    return y, {k: total[i] / n for i, k in enumerate(keys)}


def moe_apply(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig,
              ctx: Optional[EPContext] = None, with_metrics: bool = True,
              rt=None) -> Tuple[torch.Tensor, dict]:
    """Entry point: :func:`moe_ep` when an expert-parallel context is given
    and ``cfg.moe.impl == 'ep'``, else the dense execution (on a rank
    mesh, ``rt.mesh``, its router metrics averaged over the ranks the
    tokens are spread on)."""
    if ctx is not None and cfg.moe.impl == 'ep':
        return moe_ep(p, x, cfg, yoco, ctx)
    group = None if rt is None or rt.mesh is None else rt.token_group()
    return moe_dense(p, x, cfg, yoco, with_metrics, group)


def moe_ep_job(mesh, *, cfg, params, x, r, seq_split: bool,
               with_grads: bool = False, device=None) -> dict:
    """A mesh job (``distributed/ranks.py::mesh_job``): :func:`moe_ep` on
    this rank's tokens of the global ``x`` (B, S, d) (numpy; its dp rows,
    and with ``seq_split`` its 1/ep of the sequence, else the whole
    sequence, replicated over the EP axis) and its block of the expert
    stacks of ``params`` (numpy, the reference's ``init_moe`` tree), in
    x's dtype, on ``device`` (default: the rank's). Returns this rank's
    output block and metrics, and with
    ``with_grads`` the gradients of ``sum(y * r)`` (``r`` the global
    cotangent, numpy) with respect to the rank's x block and every leaf
    of ``p`` (the expert stacks' blocks)."""
    import numpy as np
    from repro_torch import device as device_mod
    dev = device_mod.resolve(device or mesh.device)
    ep = mesh.axis_size('model')
    e_loc = cfg.moe.stack_size // ep
    i_ep = mesh.index('model')
    p = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v)).to(dev)
        if k in STACKS:
            t = stack_layout(k, t[i_ep * e_loc:(i_ep + 1) * e_loc])
        p[k] = t.requires_grad_(with_grads)
    dp = mesh.axis_size(('data',))
    b = x.shape[0] // dp
    rows = slice(mesh.index(('data',)) * b, (mesh.index(('data',)) + 1) * b)
    s = x.shape[1] // ep if seq_split else x.shape[1]
    cols = slice(i_ep * s, (i_ep + 1) * s) if seq_split else slice(None)
    xl = torch.from_numpy(np.array(x[rows, cols])).to(dev).requires_grad_(with_grads)
    ctx = EPContext(mesh, ('data',), 'model', seq_split=seq_split)
    with torch.set_grad_enabled(with_grads):
        y, m = moe_ep(p, xl, cfg, YocoConfig(compute_dtype=xl.dtype), ctx)
        out = dict(y=y.detach().cpu().numpy(),
                   metrics={k: float(v.detach()) for k, v in m.items()})
        if with_grads:
            rl = torch.from_numpy(np.array(r[rows, cols])).to(dev)
            torch.sum(y * rl).backward()
            out['dx'] = xl.grad.cpu().numpy()
            out['dp'] = {k: v.grad.cpu().numpy() for k, v in p.items()}
    return out
