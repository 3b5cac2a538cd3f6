"""The head-parallel serving layout (port of the serving half of
``repro/distributed/sharding.py``, ``:209-266``).

Serving TP splits only what carries an attention head axis: the head
projections ``wq``, ``wk``, ``wv`` (MLA: ``w_uq``, ``w_ukv``) and the q/k/v
biases, each on its last (output) dim, whose values are head-major, so a
rank holds a contiguous slice of heads; and the GQA KV pools on their Hkv
axis (``runtime/layouts.py::stack_layers``, which allocates a rank's
part). Everything else, ``wo``,
the MLP, the experts, the MLA down-projections and latent pool, the
embeddings and the ``lm_head``, is replicated on every rank on purpose:
every rank then runs the same non-attention math, the per-layer head
all-gather is the only collective, and the tokens equal one device's.
A rank draws its own tree (:func:`rank_transform`): each head projection
is cut as it is drawn, so a rank never holds the whole tree.

The port's storage is followed: bf16 leaves are (K, N) row-major,
dynamic-mode f32 masters and prequantized int8 codes are K-major (a view
of an (N, K)-contiguous tensor, so a slice of N is a slice of rows) with
``(1, N)`` scales. A slice keeps its leaf's layout.

The training half (``:31-206``, ``:269-341``) follows: the reference's
logical-axis rules (``param_specs`` under the ``'tp'`` and ``'fsdp2d'``
layouts, ``batch_specs``, ``cache_specs``, ``opt_specs``, ``sanitize``)
over the port's tree, with a port-local :class:`PartitionSpec`. The port's
layer stacks are lists of per-layer dicts, so a layer's spec is the
reference's stacked spec without its leading None. :func:`shard_tree` cuts
a rank's blocks of a tree (the reference's ``to_shardings`` placed on a
mesh), :func:`unshard_tree` gathers them back, and :func:`compute_specs`
says which of a block's axes the sharded train step keeps for its compute
(``runtime/train_step.py``, and with ``serve`` the sharded serving steps
of ``runtime/serve_step.py``), every other axis being gathered first;
:func:`zeros_blocks` allocates a rank's blocks of a cache it never holds
whole.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch

from repro_torch.core.yoco_linear import QuantizedWeight
from repro_torch.models import attention
from repro_torch.models import model as model_mod

#: attention projections whose last dim is head-major (head, dh) flattened
SERVE_TP_HEAD_MATS = ('wq', 'wk', 'wv', 'w_uq', 'w_ukv')
SERVE_TP_HEAD_VECS = ('bq', 'bk', 'bv')


def validate_serve_tp(cfg, tp: int) -> None:
    """Refuse what the head-parallel layout cannot split exactly, with the
    reference's exceptions and messages: both the query and (GQA) the KV
    head counts must divide ``tp``, so the grouping g = H / Hkv survives
    the split and every rank's attention is an exact slice of the whole."""
    if tp < 1:
        raise ValueError(f'tp must be >= 1, got {tp}')
    if tp == 1:
        return
    if cfg.family == 'ssm' or cfg.hybrid_group:
        raise NotImplementedError(
            f'serving TP shards attention heads; family={cfg.family!r} '
            'carries recurrent state with no head-parallel split')
    if cfg.n_heads % tp:
        raise ValueError(
            f'n_heads={cfg.n_heads} does not divide tp={tp}')
    if cfg.mla is None and cfg.n_kv_heads % tp:
        raise ValueError(
            f'n_kv_heads={cfg.n_kv_heads} does not divide tp={tp} '
            '(the KV pools shard on the Hkv axis)')


def _slice_last(w: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/tp of ``w``'s last dim, a tensor of its
    own in ``w``'s layout (K-major stays K-major)."""
    per = w.shape[-1] // tp
    if w.ndim >= 2 and not w.is_contiguous() and \
            w.transpose(-1, -2).is_contiguous():
        rows = w.transpose(-1, -2)[..., rank * per:(rank + 1) * per, :]
        return rows.clone(memory_format=torch.contiguous_format) \
            .transpose(-1, -2)
    return w[..., rank * per:(rank + 1) * per].clone(
        memory_format=torch.contiguous_format)


def _cut(w, rank: int, tp: int):
    """Rank ``rank``'s slice of a head leaf (a ``QuantizedWeight``'s codes
    and scales alike)."""
    if isinstance(w, QuantizedWeight):
        return QuantizedWeight(_slice_last(w.wq, rank, tp),
                               _slice_last(w.scale, rank, tp))
    return _slice_last(w, rank, tp)


def rank_transform(transform, rank: int, tp: int):
    """An ``init_params`` leaf transform that draws a rank's tree: each
    weight drawn whole from the seeded stream of tp = 1 and put in its
    serving form by ``transform``, then each head projection cut to the
    rank's heads, so no whole projection outlives its draw. The q/k/v
    biases are not drawn through a transform: :func:`shard_serve_params`
    with ``drawn=True`` cuts them."""
    def cut(name, w, mult):
        w = transform(name, w, mult)
        return _cut(w, rank, tp) if name in SERVE_TP_HEAD_MATS else w
    return cut


def shard_serve_params(params, rank: int, tp: int, *, drawn: bool = False):
    """Rank ``rank``'s tree of ``tp``: every head projection and q/k/v bias
    sliced to the rank's heads (``drawn``: the projections already are,
    drawn through :func:`rank_transform`, and only the biases are cut),
    MLA's ``W_uv`` at the whole head count added beside each ``w_ukv``
    (``attention.tp_uv_weight``, built once here for every step), every
    other leaf passed through uncopied."""
    if tp == 1:
        return params
    names = SERVE_TP_HEAD_VECS + (() if drawn else SERVE_TP_HEAD_MATS)

    def walk(node, name=''):
        if isinstance(node, dict):
            out = {k: walk(v, k) for k, v in node.items()}
            if 'w_ukv' in out:
                out[attention.TP_UV_KEY] = attention.tp_uv_weight(
                    out['w_ukv'], rank, tp)
            return out
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return _cut(node, rank, tp) if name in names else node
    return walk(params)


def nbytes(tree) -> int:
    """Bytes of a tree's tensors (each leaf's elements; a broadcast view
    counts its full shape)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@functools.lru_cache(maxsize=None)
def serving_bytes(cfg, mode: str, prequantize: bool, dtype: torch.dtype,
                  tp: int) -> int:
    """A rank's weight bytes in their serving form at ``tp``: the rank's
    draw made on the meta device (``model.serving_bytes``' with
    :func:`rank_transform`): replicated leaves whole, head leaves / tp,
    MLA's whole-count ``W_uv``. The draw's transient, one weight whole
    while it is cut, is not counted, as at tp = 1."""
    transform = model_mod.serving_transform(mode, prequantize, dtype)
    tree = model_mod.init_params(None, cfg, device='meta',
                                 transform=rank_transform(transform, 0, tp))
    return nbytes(shard_serve_params(tree, 0, tp, drawn=True))


def pool_bytes(cfg, tp: int, **pool) -> int:
    """A rank's paged cache bytes at ``tp``: ``model.init_paged_cache_tree
    (cfg, tp=tp, **pool)`` made on the meta device (GQA pools and their
    int8 tiers / tp, MLA latent pools whole)."""
    return nbytes(model_mod.init_paged_cache_tree(cfg, device='meta', tp=tp,
                                                  **pool))


# ----------------------------------------------------------------------------
# training layouts (the reference's :31-206 and :269-341)
# ----------------------------------------------------------------------------
class PartitionSpec(tuple):
    """A leaf's spec, one entry a dim: an axis name, a tuple of names (the
    dim cut over their product, the first name slowest) or None (whole).
    Dims past its length are whole. Compares as the plain tuple. A tuple
    of one name is that name, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            (a[0] if len(a) == 1 else tuple(a))
            if isinstance(a, (tuple, list)) else a for a in axes))

    def __repr__(self) -> str:
        return f'P{tuple.__repr__(self)}'


P = PartitionSpec

# parameters whose last two dims are (d_in, d_out) column-parallel
_COL_NAMES = ('wq', 'wk', 'wv', 'w_gate', 'w_up', 'w_in', 'sh_gate', 'sh_up',
              'sh_in', 'w_dq', 'w_uq', 'w_dkv', 'w_ukv', 'in_proj')
# row-parallel (contracting dim sharded over 'model')
_ROW_NAMES = ('wo', 'w_down', 'w_out', 'sh_down', 'sh_out', 'out_proj')
# per-head / per-channel vectors sharded over 'model'
_TP_VECS = ('bq', 'bk', 'bv', 'conv_b', 'a_log', 'dt_bias', 'd_skip',
            'gate_norm')
_EXPERT_IN = ('w_gate', 'w_up', 'w_in')
_EXPERT_OUT = ('w_down', 'w_out')
# the layer lists, each the reference's stacked (L, ...) subtree
_STACKED_PREFIXES = ('layers', 'dense_prefix')


def _core_spec(path: str, shape) -> tuple:
    """The reference's ``_core_spec``: the spec of a parameter's unstacked
    trailing dims under the 'tp' layout."""
    name = path.split('/')[-1]
    nd = len(shape)
    if 'moe' in path.split('/') and name in _EXPERT_IN:
        return ('model', 'data', None)               # (E, d, f): EP + FSDP
    if 'moe' in path.split('/') and name in _EXPERT_OUT:
        return ('model', None, 'data')               # (E, f, d)
    if name == 'router':
        return ('data', None)
    if name == 'embed':
        if nd >= 3:                                  # (CB, V, d)
            return (None, 'model', None)
        return ('model', None)                       # (V, d): vocab over TP
    if name == 'lm_head':
        if nd >= 3:                                  # (CB, d, V)
            return (None, 'data', 'model')
        return ('data', 'model')                     # logits vocab-sharded
    if name == 'conv_w':
        return (None, 'model')                       # (W, conv_dim)
    if name in _COL_NAMES:
        return ('data', 'model')
    if name in _ROW_NAMES:
        return ('model', 'data')
    if name in _TP_VECS:
        return ('model',)
    return (None,)                                   # norms etc: replicated


def _axis_size(mesh, axis) -> int:
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(math.prod(mesh.shape[a] for a in axis))
    return int(mesh.shape[axis])


def sanitize(spec, shape, mesh):
    """Drop spec axes that do not divide the dim evenly, as the reference
    does (qwen2-moe's 60 experts over a 16-way axis, batch-1 caches); a
    dim of several stacked axes smaller than their product is a spec bug
    and raises the reference's ``ValueError``."""
    if mesh is None:
        return spec
    out = []
    for d, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        sz = _axis_size(mesh, ax)
        if (isinstance(ax, (tuple, list)) and len(ax) > 1
                and 0 < shape[d] < sz):
            raise ValueError(
                f'stacked mesh axes {tuple(ax)} (product {sz}) cannot '
                f'shard dim {d} of shape {tuple(shape)}: dim size '
                f'{shape[d]} < {sz}. Drop an axis from the spec or use a '
                f'single-axis spec (single axes that do not divide are '
                f'dropped automatically).')
        out.append(ax if sz > 1 and shape[d] % sz == 0 else None)
    return P(*out)


def _fsdp2d_spec(path: str, shape) -> tuple:
    """The reference's 'fsdp2d' rule: every big matrix sharded over both
    axes on one dim (the 16 * 16 of the production mesh, as the reference
    writes it), experts keeping EP over 'model', embeddings and lm_head
    vocab over 'model'."""
    name = path.split('/')[-1]
    nd = len(shape)
    both = ('data', 'model')
    if 'moe' in path.split('/') and name in _EXPERT_IN:
        return ('model', 'data', None)
    if 'moe' in path.split('/') and name in _EXPERT_OUT:
        return ('model', None, 'data')
    if name == 'router':
        return (both, None)
    if name == 'embed':
        return (None, 'model', 'data') if nd >= 3 else ('model', 'data')
    if name == 'lm_head':
        return (None, 'data', 'model') if nd >= 3 else ('data', 'model')
    if name == 'conv_w':
        return (None, both)
    if name in _COL_NAMES or name in _ROW_NAMES:
        d0, d1 = shape[-2:]
        order = [(-2, d0), (-1, d1)] if d0 >= d1 else [(-1, d1), (-2, d0)]
        for axes in (both, ('model',), ('data',)):
            sz = 16 * 16 if axes == both else 16
            for dim, ext in order:
                if ext % sz == 0:
                    sp = [None, None]
                    sp[dim] = axes if axes == both else axes[0]
                    return tuple(sp)
        return (None, None)
    if name in _TP_VECS:
        return (both,)
    return (None,)


def _walk(tree, fn, path=(), depth=None):
    """``fn(path, leaf, stacked)`` on every leaf of a port tree (dicts,
    per-layer lists, NamedTuples), rebuilt in the tree's shape. ``path``
    joins the dict keys and field names (a list index is no part of it,
    as a stacked leaf's path in the reference); ``stacked`` is the length
    of the layer list a leaf sits in (None outside one)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,), depth) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path, len(tree)) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_walk(v, fn, path + (f,), depth)
                            for f, v in zip(tree._fields, tree)))
    return fn('/'.join(path), tree, depth)


def _param_spec(ps: str, shape, mesh, rule):
    """The reference's ``param_specs`` body for one leaf at path ``ps``
    with its (stacked, where the reference stacks it) ``shape``."""
    parts = ps.split('/')
    name = parts[-1]
    quant_parent = len(parts) >= 2 and parts[-2] in \
        _COL_NAMES + _ROW_NAMES + ('lm_head',)
    if name == 'wq' and quant_parent:
        ps = '/'.join(parts[:-1])
        name = parts[-2]
    elif name == 'scale' and quant_parent:
        # (..., 1, N): cut as its weight's output dim (the reference's
        # stacked (L, 1, N) scale names its dim of size 1, which sanitize
        # drops: its codes' column block would then meet whole scales)
        core = rule('/'.join(parts[:-1]), (1, 1))
        last = core[-1] if len(core) >= 2 else None
        return P(*([None] * (len(shape) - 2)),
                 *sanitize(P(None, last), shape[-2:], mesh))
    nd = len(shape)
    stacked = parts[0] in _STACKED_PREFIXES
    if parts[0] == 'shared' and parts[-1] == 'in_proj' and nd == 3:
        return sanitize(P(None, 'data', 'model'), shape, mesh)
    if name in ('embed', 'lm_head') or parts[0] == 'final_norm':
        if name not in ('embed', 'lm_head'):
            return P()
        core = rule(ps, shape)
        return sanitize(P(*core[:nd]), shape, mesh)
    core = list(rule(ps, shape[1:] if stacked else shape))
    if stacked:
        core = [None] + core
    core = (core + [None] * nd)[:nd]
    return sanitize(P(*core), shape, mesh)


def param_specs(params, mesh=None, layout: str = 'tp'):
    """A spec for every leaf of the port's param tree (``layout``: 'tp',
    Megatron TP x FSDP, or 'fsdp2d'). A leaf of a layer list gets the
    reference's spec of the stacked leaf, computed on the stacked shape,
    without its leading entry; a ``QuantizedWeight``'s children inherit
    their weight's rule."""
    rule = _core_spec if layout == 'tp' else _fsdp2d_spec

    def spec(ps, leaf, stacked):
        shape = tuple(leaf.shape)
        if stacked is None:
            return _param_spec(ps, shape, mesh, rule)
        return P(*_param_spec(ps, (stacked,) + shape, mesh, rule)[1:])
    return _walk(params, spec)


def batch_specs(cfg, dp_axes: Tuple[str, ...]) -> dict:
    """Specs for a training batch dict(inputs, labels): rows over the dp
    axes."""
    if cfg.input_kind in ('embeddings', 'codebooks'):
        return dict(inputs=P(dp_axes, None, None),
                    labels=P(dp_axes, None) if cfg.input_kind ==
                    'embeddings' else P(dp_axes, None, None))
    return dict(inputs=P(dp_axes, None), labels=P(dp_axes, None))


def cache_specs(cache, *, batch: int, dp_axes: Tuple[str, ...], mesh,
                tp_axis: str = 'model'):
    """KV/SSM cache specs, the reference's: batch over the dp axes, heads
    (or, for few KV heads, the sequence) over ``tp_axis``; a batch too
    small to fill the dp axes shards the sequence over them instead."""
    dp_size = int(math.prod(mesh.shape[a] for a in dp_axes))
    seq_parallel = batch < dp_size

    def spec_for(ps, leaf, stacked):
        name = ps.split('/')[-1]
        shape = tuple(leaf.shape)
        if name == 'k' or name == 'v':      # (L|sites, B, S, Hkv, dh)
            heads_ok = shape[3] % mesh.shape[tp_axis] == 0
            if seq_parallel:
                sp = P(None, None, dp_axes, tp_axis if heads_ok else None,
                       None)
            elif heads_ok:
                sp = P(None, dp_axes, None, tp_axis, None)
            else:
                sp = P(None, dp_axes, tp_axis, None, None)
            return sanitize(sp, shape, mesh)
        if name == 'ckv' or name == 'krope':   # (L, B, S, r)
            sp = (P(None, None, dp_axes, None) if seq_parallel
                  else P(None, dp_axes, tp_axis, None))
            return sanitize(sp, shape, mesh)
        if name == 'conv':                  # (L, B, W-1, C)
            return sanitize(P(None, dp_axes if not seq_parallel else None,
                              None, tp_axis), shape, mesh)
        if name == 'ssm':                   # (L, B, H, Pdim, N)
            return sanitize(P(None, dp_axes if not seq_parallel else None,
                              tp_axis, None, None), shape, mesh)
        return P(*([None] * len(shape)))
    return _walk(cache, spec_for)


def opt_specs(pspecs, opt_state):
    """Optimizer state mirrors the parameters' specs; the step is
    replicated."""
    from repro_torch.optim import adamw
    ef = None if opt_state.ef is None else pspecs
    return adamw.OptState(step=P(), mu=pspecs, nu=pspecs, ef=ef)


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return ('pod', 'data') if 'pod' in mesh.axis_names else ('data',)


# ----------------------------------------------------------------------------
# a rank's blocks
# ----------------------------------------------------------------------------
def spec_axes(spec, nd: int) -> list:
    """(dim, axes tuple) of every sharded dim of a spec, over ``nd`` dims."""
    out = []
    for d, ax in enumerate(tuple(spec)[:nd]):
        if ax is not None:
            out.append((d, (ax,) if isinstance(ax, str) else tuple(ax)))
    return out


def memory_order(t: torch.Tensor) -> list:
    """t's dims, outermost in memory first (the order that makes
    ``t.permute(order)`` contiguous for a dense tensor)."""
    return sorted(range(t.ndim), key=lambda d: (-t.stride(d), d))


def with_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t's values laid out in memory as ``like`` is (a K-major master, an
    expert stack's (d, E, f) order): a copy unless already so."""
    order = memory_order(like)
    inv = sorted(range(len(order)), key=order.__getitem__)
    return t.permute(order).contiguous().permute(inv)


def block_index(shape, spec, mesh, coords=None) -> tuple:
    """The index of the block of a leaf of ``shape`` that the rank at
    ``coords`` (default: the mesh's own rank) holds under ``spec``."""
    coords = mesh.coords if coords is None else coords
    idx = [slice(None)] * len(shape)
    for d, axes in spec_axes(spec, len(shape)):
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + coords[a]
        size = shape[d] // n
        idx[d] = slice(i * size, (i + 1) * size)
    return tuple(idx)


def block(t: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """The block of ``t`` that the rank at ``coords`` (default: the mesh's
    own rank) holds under ``spec``: a tensor of its own, laid out as t."""
    out = with_layout(t[block_index(t.shape, spec, mesh, coords)], t)
    if out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        out = out.clone()           # a whole leaf: a copy all the same
    return out


def shard_tree(tree, specs, mesh, coords=None):
    """Every leaf's block under its spec (the reference's
    ``to_shardings`` placed on the mesh), for this rank or the one at
    ``coords``."""
    from repro_torch.optim import adamw
    return adamw.tree_map(lambda t, s: block(t, s, mesh, coords), tree,
                          specs)


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    return tuple(len(range(*sl.indices(n)))
                 for sl, n in zip(block_index(shape, spec, mesh,
                                              {a: 0 for a in mesh.shape}),
                                  shape))


def zeros_blocks(tree, specs, mesh, device):
    """A rank's zeroed blocks of every leaf of ``tree`` (whose leaves give
    shapes and dtypes only, e.g. on the meta device), allocated at their
    block shapes on ``device``: a sharded cache no rank holds whole."""
    from repro_torch.optim import adamw
    return adamw.tree_map(
        lambda t, s: torch.zeros(block_shape(t.shape, s, mesh),
                                 dtype=t.dtype, device=device), tree, specs)


def unshard_tree(tree, specs, mesh):
    """The whole leaves from every rank's blocks (all-gathers over each
    sharded dim's axes, in the mesh's order); every rank must call it."""
    from repro_torch.distributed import collectives
    from repro_torch.optim import adamw

    def whole(t, spec):
        for d, axes in spec_axes(spec, t.ndim):
            t = collectives.all_gather_dim(t, d, mesh.group(axes))
        return t
    return adamw.tree_map(whole, tree, specs)


# ----------------------------------------------------------------------------
# what the sharded train step computes on
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPPlan:
    """The products the 'tp' layout splits over 'model' (a rank's block
    kept for its compute): the attention heads (a rank's whole heads
    only), the dense MLP's hidden units, the vocab of the embedding and
    the lm_head. Each is False where 'model' does not divide it, or off
    the 'tp' layout."""
    heads: bool = False
    mlp: bool = False
    vocab: bool = False


def tp_plan(cfg, mesh, act_layout: str, serve: bool = False) -> TPPlan:
    """``serve``: the plan of the sharded serving steps, whose static
    cache is cut on the KV heads only for GQA (:func:`cache_specs`), so
    an MLA rank computes every head (its latent cache is cut on the
    sequence)."""
    t = _axis_size(mesh, 'model') if mesh is not None else 1
    if t == 1 or act_layout != 'batch':
        return TPPlan()
    heads = cfg.n_heads % t == 0 and (
        (cfg.mla is not None and not serve)
        or (cfg.mla is None and cfg.n_kv_heads % t == 0))
    return TPPlan(heads=heads, mlp=cfg.d_ff % t == 0,
                  vocab=(cfg.vocab_size % t == 0
                         and cfg.input_kind != 'codebooks'))


_HEAD_LEAVES = ('wq', 'wk', 'wv', 'wo', 'bq', 'bk', 'bv')
_MLA_HEAD_LEAVES = ('w_uq', 'w_ukv', 'wo')
_MLP_LEAVES = ('w_gate', 'w_up', 'w_in', 'w_down', 'w_out')


def _kept(ps: str, nd: int, cfg, plan: TPPlan, use_ep: bool) -> bool:
    """Whether the train step computes on this leaf's 'model' block (a
    ``QuantizedWeight``'s codes and scales as their weight)."""
    parts = ps.split('/')
    if len(parts) >= 2 and parts[-1] in ('wq', 'scale') and \
            parts[-2] in _COL_NAMES + _ROW_NAMES + ('lm_head',):
        parts = parts[:-1]
    name, parent = parts[-1], parts[-2] if len(parts) > 1 else ''
    if nd == 3 and name in _MLP_LEAVES and 'moe' in parts:
        return use_ep                                # expert parallelism
    if parent == 'attn':
        names = _MLA_HEAD_LEAVES if cfg.mla is not None else _HEAD_LEAVES
        return plan.heads and name in names
    if parent == 'mlp':
        return plan.mlp and name in _MLP_LEAVES
    if name in ('embed', 'lm_head') and nd == 2:
        return plan.vocab
    return False


def compute_specs(params, pspecs, cfg, mesh, act_layout: str,
                  use_ep: bool, serve: bool = False):
    """For each leaf, the part of its spec the train step (``serve``: the
    sharded serving steps, :func:`tp_plan`'s) keeps while it computes:
    the 'model' entry of the blocks the 'tp' layout splits
    (:func:`tp_plan`) and of the expert stacks under expert parallelism;
    every other axis of the spec is gathered before use."""
    plan = tp_plan(cfg, mesh, act_layout, serve)
    flat = iter(_flat_specs(pspecs))

    def keep(ps, leaf, stacked):
        spec = next(flat)
        nd = len(leaf.shape)
        on = _kept(ps, nd, cfg, plan, use_ep)
        full = tuple(spec) + (None,) * (nd - len(spec))
        return P(*(a if on and a == 'model' else None for a in full))
    return _walk(params, keep)


def _flat_specs(specs) -> list:
    out = []

    def visit(node):
        if isinstance(node, PartitionSpec):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
    visit(specs)
    return out


def leaves_with_specs(tree, specs) -> list:
    """(leaf, spec) pairs in ``optim/adamw.py::tree_leaves``' order (dicts
    by sorted key)."""
    out = []

    def visit(node, spec):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], spec[k])
        elif isinstance(node, (list, tuple)) and not isinstance(
                node, torch.Tensor):
            for v, s in zip(node, spec):
                visit(v, s)
        else:
            out.append((node, spec))
    visit(tree, specs)
    return out


def sharded_axes(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes a spec cuts some dim over, in mesh order."""
    named = {a for _, axes in spec_axes(spec, len(spec)) for a in axes}
    return tuple(a for a in mesh.axis_names if a in named)


def replicated_axes(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes a spec leaves its leaf whole over."""
    cut = sharded_axes(spec, mesh)
    return tuple(a for a in mesh.axis_names if a not in cut)
