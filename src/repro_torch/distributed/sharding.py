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

The training half of the reference's module (``param_specs``,
``_fsdp2d_spec``, ``cache_specs``, ``opt_specs``) goes with sharded
training (ROADMAP Queue 1, item 14b).
"""

from __future__ import annotations

import functools

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
