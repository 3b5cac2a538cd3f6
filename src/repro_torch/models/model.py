"""Model assembly (port of ``repro/models/model.py``).

  init_params(gen, cfg, device, transform=None)  -> param tree
  init_cache_tree(cfg, batch, max_seq, ...)      -> contiguous cache tree
  init_paged_cache_tree(cfg, batch, ...)         -> paged cache tree
  prefill(params, batch, cache, cfg, ...)        -> (last_logits, cache)
  prefill_chunk(params, batch, offset, limit, cache, ...)
                                                 -> (logits, cache)
  decode_step(params, token, pos, cache, ...)    -> (logits, cache)
  forward(params, batch, cfg, ...)               -> (logits, metrics)
  loss_fn(params, batch, cfg, ...)               -> (loss, metrics)

Parameters are a plain dict with the reference's names; ``layers`` is a
list of per-layer dicts (a Python loop replaces ``lax.scan``). Caches keep
the reference's layer-stacked schema, ``dict(layers=dict(k=(L, P, ps, Hkv,
dh), v=..., bt=(L, B, W)))`` (MLA configs: one latent pool ``cl`` (L, P,
ps, r + d_rope)), or contiguous ``dict(layers=dict(k=(L, B, S_max, Hkv,
dh), v=...))`` (MLA: ``ckv``/``krope`` (L, B, S_max, ·)); each layer works
on views of the stacked tensors and writes them IN PLACE. Served: every
config the reference registers. Token models with GQA or MLA attention
and dense MLPs or MoE FFNs, gemma3's local/global layers included: each layer takes its own (window, rope theta) from
:func:`_gemma_layer_meta`, the windows as one device tensor a (config,
device) (:func:`layer_windows`), so no step copies a window to the card.
MoE configs: every layer in ``layers`` has an MoE FFN (qwen2-moe), or,
with ``first_k_dense`` (deepseek-v3), a ``dense_prefix`` list runs first
and the caches are ``dict(prefix=..., moe=...)``, each stacked over its
own layers, as in the reference. Recurrent configs: a pure SSM
(mamba2-780m) runs Mamba2 blocks in ``layers`` over ``dict(ssm=dict(conv=
(L, B, W-1, C), ssm=(L, B, H, P, N)))``, f32 rows updated in place; a
hybrid (zamba2-1.2b) runs its ``layers`` in groups of ``hybrid_group - 1``
Mamba2 blocks, each followed by one application of the ``shared``
attention+MLP block at its own site, then the trailing Mamba2 blocks,
over ``dict(ssm=..., attn=...)`` (the sites' caches stacked over sites,
one set of block tables broadcast over them). The two non-token
frontends, as in the reference: ``embeddings`` input (qwen2-vl: (B, S, d)
precomputed patch embeddings, cast to the compute dtype; no ``embed``
table; M-RoPE in attention) and ``codebooks`` input (musicgen: (B, S, CB)
ids, ``embed`` (CB, V, d) summed over the codebooks, ``lm_head`` (CB, d,
V) a float einsum giving (B, S, CB, V) logits in every mode).

``params_from_numpy`` / ``params_to_numpy`` / ``cache_from_numpy`` /
``cache_to_numpy`` carry the reference's trees (as numpy arrays) across, so
the two packages can be run on the same weights and compared pool for
pool, and a checkpoint of either restores in the other.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import yoco_linear
from repro_torch.core.yoco_linear import DEFAULT_YOCO, QuantizedWeight, YocoConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import layers as layers_mod
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                       init_norm)


@dataclasses.dataclass(frozen=True, eq=False)
class ModelRuntime:
    # sharded training (runtime/train_step.py::sharded_train_step): the
    # rank mesh (launch/mesh.py::RankMesh) or None (one device)
    mesh: Any = None
    dp_axes: tuple = ('data',)     # batch axes; ('pod', 'data') multi-pod
    tp_axis: str = 'model'
    use_ep: bool = False           # expert-parallel MoE (needs a mesh)
    remat: str = 'none'            # none | full | dots
    act_layout: str = 'batch'      # batch (the 'tp' layout) | 2d (fsdp2d)
    attn_impl: str = 'einsum'      # einsum (oracle) | flash (the kernels)
    compute_dtype: Any = torch.bfloat16
    # head-parallel serving TP: the rank's torch.distributed group (None:
    # one device); the attention gathers its heads over it before wo
    tp_group: Any = None
    # set by forward: under act_layout '2d' this rank holds its 1/T of the
    # sequence (T = the tp axis's size), at positions from seq_offset on
    seq_sharded: bool = False
    # serving on a mesh (runtime/serve_step.py::sharded_decode_step): the
    # axes the static cache's sequence dim is cut over; a rank holds its
    # block of the keys, scores them and merges over these axes
    kv_seq_axes: tuple = ()
    # and the (leaf, dim) of each recurrent leaf of one layer that a rank
    # holds a block of over the tp axis (sharding.cache_specs: conv's
    # channels, ssm's heads); the mixer gathers them whole
    state_cut: tuple = ()

    @property
    def moe_ctx(self) -> Optional[moe_mod.EPContext]:
        if self.use_ep and self.mesh is not None:
            return moe_mod.EPContext(self.mesh, self.dp_axes, self.tp_axis,
                                     seq_split=self.seq_sharded)
        return None

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(self.tp_axis)

    def model_group(self):
        """The group of this rank's 'model' line (None: one rank)."""
        return None if self.mesh is None else self.mesh.group(self.tp_axis)

    def token_axes(self) -> tuple:
        """The axes this rank's tokens are a part of: the dp axes, and the
        tp axis when the sequence is split over it."""
        return tuple(self.dp_axes) + ((self.tp_axis,) if self.seq_sharded
                                      else ())

    def token_group(self):
        return None if self.mesh is None else self.mesh.group(
            self.token_axes())

    def seq_offset(self, s_local: int) -> int:
        """The position of this rank's first row of the sequence."""
        if not self.seq_sharded:
            return 0
        return self.mesh.index(self.tp_axis) * s_local

    def kv_seq_group(self):
        """The group the cache's sequence is cut over (None: whole)."""
        if self.mesh is None or not self.kv_seq_axes:
            return None
        return self.mesh.group(self.kv_seq_axes)

    def kv_seq_offset(self, s_block: int) -> int:
        """The position of this rank's first cache row of ``s_block``."""
        if self.kv_seq_group() is None:
            return 0
        return self.mesh.index(self.kv_seq_axes) * s_block

    def columns(self):
        """(rank, ways) of a column block over the tp axis: this rank's
        index on it and its size."""
        if self.mesh is None or self.tp_size == 1:
            return 0, 1
        return self.mesh.index(self.tp_axis), self.tp_size


DEFAULT_RT = ModelRuntime()


def _dots_policy(ctx, op, *args, **kwargs):
    """The counterpart of JAX's ``dots_with_no_batch_dims_saveable``: the
    matrix products with no batch dims (every linear's) are saved, all
    else recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    saved = (aten.mm.default, aten.addmm.default, aten._int_mm.default)
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, rt: ModelRuntime):
    """``fn`` under ``rt.remat``: 'none' as it is; 'full' through
    non-reentrant ``torch.utils.checkpoint`` (nothing saved, the whole body
    recomputed in the backward); 'dots' the same with a selective policy
    saving the matrix products (:func:`_dots_policy`)."""
    if rt.remat == 'none':
        return fn
    from torch.utils import checkpoint as ckpt
    if rt.remat == 'full':
        kw = {}
    elif rt.remat == 'dots':
        kw = dict(context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy))
    else:
        raise ValueError(f'remat must be none, full or dots; got '
                         f'{rt.remat!r}')

    def run(*a):
        # the whole body again in the backward (no early stop), so a
        # recompute makes every collective and launch of the forward
        with ckpt.set_checkpoint_early_stop(False):
            return ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)
    return run


INPUT_KINDS = ('tokens', 'embeddings', 'codebooks')


def _check_served(cfg) -> None:
    """Refuse, by feature, an input kind the reference does not have (a
    family name says too little: deepseek-v3's dense prefix keeps
    ``family='moe'`` with ``moe=None``, as in the reference)."""
    if cfg.input_kind not in INPUT_KINDS:
        raise NotImplementedError(
            f'{cfg.name}: {cfg.input_kind!r} input is no input kind of the '
            f'reference; the port serves {", ".join(INPUT_KINDS)} '
            f'(qwen2-vl-72b takes embeddings, musicgen-large codebooks)')


def _recurrent(cfg) -> bool:
    """Mamba2 layers: a pure SSM or a hybrid."""
    return cfg.family == 'ssm' or bool(cfg.hybrid_group)


def _n_sites(cfg) -> int:
    """Hybrid configs: applications of the shared attention block."""
    return cfg.n_layers // cfg.hybrid_group if cfg.hybrid_group else 0


def _n_mamba(cfg) -> int:
    """Sequence-mixing layers that are Mamba2 (a hybrid's others are the
    shared block's applications)."""
    if cfg.family == 'ssm':
        return cfg.n_layers
    if cfg.hybrid_group:
        return cfg.n_layers - _n_sites(cfg)
    return 0


def _stacks(cfg) -> Tuple[Tuple[str, str, int, bool], ...]:
    """The layer stacks in the order they run: (param key, cache key,
    layers, MoE). A ``first_k_dense`` MoE config runs ``dense_prefix`` on
    the ``prefix`` cache, then its MoE ``layers`` on ``moe``, as the
    reference does; a recurrent config none (:func:`_backbone` runs its
    Mamba2 and shared blocks); any other config ``layers`` on
    ``layers``."""
    mo = cfg.moe
    if _recurrent(cfg):
        return ()
    if mo is None:
        return (('layers', 'layers', cfg.n_layers, False),)
    if not mo.first_k_dense:
        return (('layers', 'layers', cfg.n_layers, True),)
    return (('dense_prefix', 'prefix', mo.first_k_dense, False),
            ('layers', 'moe', cfg.n_layers - mo.first_k_dense, True))


# ----------------------------------------------------------------------------
# init and interchange
# ----------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg, *, device=None,
                transform=None) -> dict:
    """Random weights with the reference's distributions (embeddings
    N(0, 0.02^2), linears N(0, 1/d_in), norms at identity), drawn from
    ``gen`` directly on ``device`` (default: the card; with no card it
    raises unless the caller passes ``device='cpu'``). The draws differ
    from JAX's PRNG; to compare with the reference use
    :func:`params_from_numpy`.

    ``transform(name, w, mult)`` (e.g. :func:`serving_transform`) takes
    each f32 linear weight, and each slice of an expert stack
    (``moe.init_moe``), right after its draw, before the next one, so at
    most one f32 linear weight or one slice of at most ``moe.DRAW_BYTES``
    is alive at a time; ``mult`` is the number of layers the weight is
    stacked over in the reference (1 for the lm_head). The draws are the
    same, in the same order, so the tree equals applying the transform to
    the f32 tree afterwards (:func:`serving_form`). On ``device='meta'``
    ``gen`` may be None: the tree then holds shapes and dtypes only
    (:func:`serving_bytes`).

    MoE configs build the reference's stacks: ``dense_prefix`` (the
    ``first_k_dense`` dense layers, drawn first) and ``layers`` (MoE).
    Recurrent configs: ``layers``, their Mamba2 blocks, and a hybrid's
    ``shared`` block (its per-site ``in_proj`` stays f32: no transform).

    Input kinds, as the reference draws them: ``embeddings`` input draws
    no ``embed`` (the frontend supplies d-wide rows); ``codebooks`` draws
    ``embed`` (CB, V, d) and ``lm_head`` (CB, d, V), one codebook after
    another, the head passed whole to ``transform``."""
    _check_served(cfg)
    device = device_mod.resolve(device)
    if transform is None:
        def transform(name, w, mult):
            return w
    p = {}
    if cfg.input_kind == 'codebooks':
        p['embed'] = torch.stack([
            embed_init(gen, cfg.vocab_size, cfg.d_model, device=device)
            for _ in range(cfg.n_codebooks)])
    elif cfg.input_kind == 'tokens':
        p['embed'] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                device=device)
    if _recurrent(cfg):
        n = _n_mamba(cfg)
        p['layers'] = [blk.init_mamba_block(
            gen, cfg, device=device,
            leaf=lambda name, w: transform(name, w, n)) for _ in range(n)]
        if cfg.hybrid_group:
            p['shared'] = blk.init_shared_block(
                gen, cfg, _n_sites(cfg), device=device,
                leaf=lambda name, w: transform(name, w, 1))
    for key, _, n, use_moe in _stacks(cfg):
        p[key] = [blk.init_transformer_block(
            gen, cfg, device=device, use_moe=use_moe,
            leaf=lambda name, w, n=n: transform(name, w, n))
            for _ in range(n)]
    p['final_norm'] = init_norm(cfg, device=device)
    if cfg.input_kind == 'codebooks':
        p['lm_head'] = transform('lm_head', torch.stack([
            dense_init(gen, cfg.d_model, cfg.vocab_size, device=device)
            for _ in range(cfg.n_codebooks)]), 1)
    elif not cfg.tie_embeddings:
        p['lm_head'] = transform('lm_head', dense_init(
            gen, cfg.d_model, cfg.vocab_size, device=device), 1)
    return p


@functools.lru_cache(maxsize=None)
def serving_bytes(cfg, mode: str, prequantize: bool,
                  dtype: torch.dtype) -> int:
    """Bytes of the tree a seeded serve draws, ``init_params(...,
    transform=serving_transform(mode, prequantize, dtype))``, counted on
    that very draw made on the meta device, which keeps each leaf's shape
    and dtype and allocates nothing (seconds of host time at 80 layers
    with ``prequantize``, as each meta op runs in Python, so each set of
    arguments is counted once)."""
    tree = init_params(None, cfg, device='meta',
                       transform=serving_transform(mode, prequantize, dtype))

    def size(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            return sum(size(v) for v in node)
        return node.numel() * node.element_size()
    return size(tree)


def _map_weights(params: dict, fn, stacks: bool = True) -> dict:
    """``fn(name, w, mult)`` on every linear weight of the tree and, with
    ``stacks``, every expert stack and codebook head (``mult``: the length
    of the layer list it sits in, as :func:`init_params` passes it)."""
    def walk(node, name='', mult=1):
        if isinstance(node, dict):
            return {k: walk(v, k, mult) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, len(node)) for v in node]
        if yoco_linear.is_linear_weight(name, node) or (
                stacks and _float_in_compute_dtype(name, node)):
            return fn(name, node, mult)
        return node
    return walk(params)


def _float_in_compute_dtype(name: str, w) -> bool:
    """The float weights a serve stores once in the compute dtype in every
    mode, never int8: expert stacks and the codebook head (the reference
    reads both only through a cast to the compute dtype)."""
    return (moe_mod.is_expert_stack(name, w)
            or layers_mod.is_codebook_head(name, w))


def _is_quantized_leaf(x) -> bool:
    return getattr(x, '_fields', None) == ('wq', 'scale')


def _layer_lists(cfg) -> set:
    """The keys of the tree whose value is a list of per-layer dicts, each
    stacked over its layers in the reference's tree."""
    return ({'layers'} if _recurrent(cfg)
            else {key for key, _, _, _ in _stacks(cfg)})


def param_count(params) -> int:
    """Elements in the tree (a ``QuantizedWeight`` counts its codes and
    scales), as the reference counts its leaves."""
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The reference's param tree, as numpy arrays (stacked ``(L, ...)``
    layer leaves, ``QuantizedWeight(wq, scale)`` leaves allowed), to the
    port's: tensors on ``device`` with each layer stack (``layers``, and
    ``dense_prefix`` of a ``first_k_dense`` MoE config) split into a list
    by its own length, int8 weights stored K-major as kernel K2 reads
    them, expert stacks in ``moe.stack_layout``."""
    _check_served(cfg)

    def conv(node, layer=None, name=''):
        if _is_quantized_leaf(node):
            wq, scale = node
            if layer is not None:
                wq, scale = wq[layer], scale[layer]
            return QuantizedWeight(yoco_linear.k_major(conv(wq)),
                                   conv(scale))
        if isinstance(node, dict):
            return {k: conv(v, layer, k) for k, v in node.items()}
        arr = np.asarray(node)
        if layer is not None:
            arr = arr[layer]
        t = torch.from_numpy(np.array(arr)).to(device)
        return (moe_mod.stack_layout(name, t)
                if moe_mod.is_expert_stack(name, t) else t)

    def length(node):
        while isinstance(node, dict):
            node = next(iter(node.values()))
        return len(node[0] if _is_quantized_leaf(node) else node)

    lists = _layer_lists(cfg)
    return {k: ([conv(v, l) for l in range(length(v))] if k in lists
                else conv(v)) for k, v in tree.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's values as a C-ordered numpy array on the host
    (bf16 as f32, which numpy lacks): a K-major or ``stack_layout`` view
    comes back as the plain (K, N) / (E, d, f) array of its values."""
    t = t.detach().to('cpu', copy=True)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.contiguous().numpy()


def params_to_numpy(params: dict, cfg) -> dict:
    """The inverse of :func:`params_from_numpy`: the port's tree as the
    reference's, numpy arrays with each layer list stacked back to (L,
    ...) leaves and each ``QuantizedWeight`` kept one (its codes as the
    plain (K, N) array). ``params_from_numpy(params_to_numpy(p), cfg,
    dev)`` holds p's values bit for bit."""
    _check_served(cfg)

    def conv(node):
        if _is_quantized_leaf(node):
            return QuantizedWeight(*(conv(v) for v in node))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_numpy(node)

    def stack(nodes):
        first = nodes[0]
        if _is_quantized_leaf(first):
            return QuantizedWeight(*(stack([n[i] for n in nodes])
                                     for i in range(2)))
        if isinstance(first, dict):
            return {k: stack([n[k] for n in nodes]) for k in first}
        return np.stack([_to_numpy(n) for n in nodes])

    lists = _layer_lists(cfg)
    return {k: (stack(v) if k in lists else conv(v))
            for k, v in params.items()}


# Kept f32 by cast_linear_weights: MLA decode absorbs W_uk into the query
# and applies W_uv to the latent output in f32 on the f32 weights, as the
# reference does (its params are f32 masters); its prefill linear casts
# w_ukv to the compute dtype per call, as every reference linear does.
_F32_WEIGHTS = ('w_ukv',)


def _cast_leaf(dtype: torch.dtype):
    def cast(name, w, mult):
        return w if name in _F32_WEIGHTS else w.to(dtype)
    return cast


def _k_major_leaf(name, w, mult):
    return yoco_linear.k_major(w)


def cast_linear_weights(params: dict, dtype: torch.dtype) -> dict:
    """Store every float linear weight, expert stack and codebook head once
    in ``dtype`` (the bf16 mode's compute dtype), which the reference casts
    to on every call instead; the weights in ``_F32_WEIGHTS`` (and the MoE
    router, which is no linear weight) stay f32."""
    return _map_weights(params, _cast_leaf(dtype))


def k_major_linear_weights(params: dict) -> dict:
    """Store every float linear weight K-major once, at load: the same
    (K, N) values as a view of an (N, K)-contiguous tensor
    (``yoco_linear.k_major``), f32 as the reference keeps them. The
    dynamic modes serve these (w8a8, qat, analog_sim): kernel K3 reads
    ``w.T`` in place and kernel K4 takes its codes as the K-major operand
    (qat dequantizes them for its float matmul), so no call copies a
    weight. One
    weight is copied at a time; one already K-major is not copied. Expert
    stacks and the codebook head are no linear weights:
    :func:`serving_form` casts them."""
    return _map_weights(params, _k_major_leaf, stacks=False)


def serving_transform(mode: str, prequantize: bool, dtype: torch.dtype):
    """The ``init_params`` transform that draws each linear weight in the
    form a serve keeps it: prequantized int8 (``quantize_tree``'s rule, in
    every mode with ``prequantize``), cast to ``dtype`` in bf16 mode
    (:func:`cast_linear_weights`'), or as f32 masters stored K-major in the
    dynamic modes, w8a8, qat and analog_sim
    (:func:`k_major_linear_weights`'). An
    expert stack and the codebook head are cast to ``dtype`` in every mode,
    never quantized and never K-major: the reference reads their f32
    masters only through a cast to the compute dtype, so storing that cast
    once is exact."""
    linear = (yoco_linear.quantize_leaf if prequantize
              else _cast_leaf(dtype) if mode == 'bf16' else _k_major_leaf)

    def transform(name, w, mult):
        if _float_in_compute_dtype(name, w):
            return w.to(dtype)
        return linear(name, w, mult)
    return transform


def serving_form(params: dict, mode: str, prequantize: bool,
                 dtype: torch.dtype) -> dict:
    """A given tree in the form a serve keeps it: :func:`serving_transform`
    on each of its linear weights, expert stacks and codebook head. A tree
    already in
    that form is returned with no weight copied."""
    return _map_weights(params, serving_transform(mode, prequantize, dtype))


def cache_from_numpy(tree, device):
    """A reference cache tree (numpy leaves) to tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: cache_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def cache_to_numpy(tree):
    """A port cache tree to numpy leaves (bf16 pools come back as f32)."""
    if isinstance(tree, dict):
        return {k: cache_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.contiguous().numpy()


# ----------------------------------------------------------------------------
# embedding / head / stack
# ----------------------------------------------------------------------------
def _embed(params: dict, inputs: torch.Tensor, cfg,
           rt: ModelRuntime) -> torch.Tensor:
    """(B, S) token ids, (B, S, CB) codebook ids or (B, S, d) embeddings
    (the stubbed frontend's rows, cast to the compute dtype) -> (B, S,
    d). A rank's vocab block of the table (the 'tp' layout) looks up the
    ids it holds, zero elsewhere, and the rows are summed over 'model'."""
    if cfg.input_kind == 'embeddings':
        return inputs.to(rt.compute_dtype)
    emb = params['embed']
    if emb.ndim == 2 and emb.shape[0] < cfg.vocab_size:
        from repro_torch.distributed import collectives
        v = emb.shape[0]
        local = inputs.to(torch.int64) - rt.mesh.index(rt.tp_axis) * v
        own = (local >= 0) & (local < v)
        rows = emb[local.clamp(0, v - 1)] * own[..., None].to(emb.dtype)
        return collectives.reduce_sum(rows.to(torch.float32),
                                      rt.model_group()).to(rt.compute_dtype)
    return layers_mod.embed_tokens(emb, inputs, rt.compute_dtype)


def _head(params: dict, x: torch.Tensor, cfg, yoco: YocoConfig,
          rt: ModelRuntime = DEFAULT_RT) -> torch.Tensor:
    """The logits; a rank's vocab block of the lm_head (or of a tied
    table) gives its block of the vocab (the 'tp' layout)."""
    w = params['embed'].t() if cfg.tie_embeddings else params['lm_head']
    if len(yoco_linear.weight_shape(w)) == 2 and \
            yoco_linear.weight_shape(w)[-1] < cfg.vocab_size:
        from repro_torch.distributed import collectives
        rank, ways = rt.columns()
        x = collectives.copy_in(x, rt.model_group())
        w = w.to(x.dtype) if cfg.tie_embeddings else w
        return yoco_linear.column_linears(x, [w], cfg=yoco, rank=rank,
                                          ways=ways)[0]
    if cfg.tie_embeddings:
        return yoco_linear.yoco_matmul(x, w.to(x.dtype), yoco)
    return layers_mod.lm_head(w, x, yoco)


@functools.lru_cache(maxsize=None)
def _gemma_layer_meta(cfg) -> Tuple[tuple, tuple]:
    """(window, theta) per layer, as Python numbers, for the local/global
    pattern: layer l is global iff ``l % every == every - 1``; a global
    layer gets window ``max_seq_len + 1`` (never binds) and the long-rope
    theta, a local one ``sliding_window`` and ``rope_theta``. With no
    pattern every layer is local."""
    every = cfg.local_global_every
    big = cfg.max_seq_len + 1
    glob = [bool(every) and l % every == every - 1
            for l in range(cfg.n_layers)]
    window = tuple(big if g else (cfg.sliding_window or big) for g in glob)
    theta = tuple(float(cfg.global_rope_theta or cfg.rope_theta) if g
                  else float(cfg.rope_theta) for g in glob)
    return window, theta


_WINDOWS: Dict[tuple, torch.Tensor] = {}


def layer_windows(cfg, device) -> Optional[torch.Tensor]:
    """The layers' sliding windows as one (L,) int32 tensor on ``device``,
    made on first use and kept for the (config, device): each layer reads
    its 0-d view, so no step copies a window host to device (a Python int
    would be one blocking copy a layer a step in the kernels' wrappers).
    None when no layer has a window."""
    if cfg.sliding_window is None:
        return None
    key = (cfg, torch.device(device))
    if key not in _WINDOWS:
        _WINDOWS[key] = torch.tensor(_gemma_layer_meta(cfg)[0],
                                     dtype=torch.int32, device=device)
    return _WINDOWS[key]


def _transformer_stack(layers: list, x: torch.Tensor, cfg, yoco, rt, *,
                       cache: Optional[dict], decode_pos, chunk_ctx=None,
                       aux: Optional[list] = None):
    """Run the layers in order; ``cache`` is the stacked (L, ...) dict or
    None, and each layer gets views of its own slice and its own (window,
    theta) (:func:`_gemma_layer_meta`; the window a view of
    :func:`layer_windows`). An MoE layer appends its load-balance loss to
    ``aux`` when one is given."""
    windows = layer_windows(cfg, x.device)
    thetas = _gemma_layer_meta(cfg)[1]
    for l, lp in enumerate(layers):
        win = None if windows is None else windows[l]
        if aux is not None:
            # training: each layer's body under rt.remat, its MoE aux loss
            # returned rather than appended, so a recompute adds none
            def body(lp, x, win=win, th=thetas[l]):
                got = []
                y, _ = blk.transformer_block(lp, x, cfg, yoco, window=win,
                                             theta=th, rt=rt, aux=got)
                return y, (got[0] if got else None)
            x, a = _maybe_remat(body, rt)(lp, x)
            if a is not None:
                aux.append(a)
            continue
        lc = ({key: leaf[l] for key, leaf in cache.items()}
              if cache is not None else None)
        x, _ = blk.transformer_block(
            lp, x, cfg, yoco, window=win, theta=thetas[l], cache=lc,
            decode_pos=decode_pos, rt=rt, chunk_ctx=chunk_ctx)
    return x, cache


def _mamba_stack(layers: list, x: torch.Tensor, cfg, yoco, *,
                 state: Optional[dict], decode: bool, last_pos=None,
                 rt: ModelRuntime = DEFAULT_RT):
    """Run Mamba2 blocks in order; ``state`` is the stacked (L, ...)
    recurrent dict or None, each layer updating its own view in place.
    Without state (training) each block runs under ``rt.remat``."""
    for l, lp in enumerate(layers):
        if state is None and not decode:
            def body(lp, x):
                return blk.mamba_block(lp, x, cfg, yoco, last_pos=last_pos,
                                       rt=rt)[0]
            x = _maybe_remat(body, rt)(lp, x)
            continue
        st = {key: leaf[l] for key, leaf in state.items()}
        whole = _whole_state(st, rt)
        x, _ = blk.mamba_block(lp, x, cfg, yoco, state=whole, decode=decode,
                               last_pos=last_pos, rt=rt)
        if whole is not st:
            _keep_block(st, whole, rt)
    return x


def _whole_state(st: dict, rt) -> dict:
    """A serving rank's block of one layer's recurrent state, gathered
    whole over 'model' along ``rt.state_cut`` (the mixer runs on the whole
    state, as training runs it on the whole weights); ``st`` itself where
    it is whole."""
    if not rt.state_cut:
        return st
    from repro_torch.distributed import collectives
    cut = dict(rt.state_cut)
    return {k: (collectives.all_gather_dim(v, cut[k], rt.model_group())
                if k in cut else v) for k, v in st.items()}


def _keep_block(st: dict, whole: dict, rt) -> None:
    """Write this rank's block of the updated whole state back."""
    from repro_torch.distributed import collectives
    for k, d in rt.state_cut:
        st[k].copy_(collectives.slice_dim(whole[k], d, rt.model_group()))


def _hybrid_backbone(params: dict, x: torch.Tensor, cfg, yoco, rt, *,
                     cache: Optional[dict], decode_pos, last_pos):
    """zamba2: ``hybrid_group - 1`` Mamba2 layers, then the shared block at
    site g on its own cache, for each of the sites; then the trailing
    Mamba2 layers. ``x0``, the embedding output, conditions every site."""
    x0 = x
    per = cfg.hybrid_group - 1
    st = cache['ssm'] if cache is not None else None
    atc = cache['attn'] if cache is not None else None
    decode = decode_pos is not None

    def mamba(x, lo, hi):
        seg = ({key: leaf[lo:hi] for key, leaf in st.items()}
               if st is not None else None)
        return _mamba_stack(params['layers'][lo:hi], x, cfg, yoco,
                            state=seg, decode=decode, last_pos=last_pos,
                            rt=rt)

    n_sites = _n_sites(cfg)
    for g in range(n_sites):
        x = mamba(x, g * per, (g + 1) * per)
        site = ({key: leaf[g] for key, leaf in atc.items()}
                if atc is not None else None)
        x, _ = blk.shared_block(params['shared'], x, x0, g, cfg, yoco,
                                cache=site, decode_pos=decode_pos, rt=rt)
    return mamba(x, n_sites * per, _n_mamba(cfg))


def _backbone(params: dict, x: torch.Tensor, cfg, yoco, rt, *,
              cache: Optional[dict], decode_pos, last_pos=None,
              chunk_ctx=None, aux: Optional[list] = None):
    """Each param stack on its own cache stack (:func:`_stacks`), each
    indexing the layer metadata by its own layer index, as the
    reference's scans do; a recurrent config's Mamba2 (and shared) blocks.

    ``last_pos`` (prefill only): per-request last valid prompt positions
    of a right-padded batch. Attention layers ignore it (the causal mask
    keeps padded keys inert); Mamba2 layers mask the padded steps' dt to
    0, so the recurrent state equals the unpadded prompt's.

    ``aux`` (training): a list each MoE layer appends its router's
    load-balance loss to (recurrent configs have none)."""
    if decode_pos is not None:
        last_pos = None         # decode steps have no padding to mask
    if _recurrent(cfg):
        if chunk_ctx is not None:
            raise NotImplementedError(
                f'chunked prefill needs random-access cache positions; '
                f'family={cfg.family!r} carries recurrent state')
        if cfg.hybrid_group:
            return _hybrid_backbone(params, x, cfg, yoco, rt, cache=cache,
                                    decode_pos=decode_pos,
                                    last_pos=last_pos), cache
        return _mamba_stack(params['layers'], x, cfg, yoco,
                            state=None if cache is None else cache['ssm'],
                            decode=decode_pos is not None,
                            last_pos=last_pos, rt=rt), cache
    for key, ckey, _, _ in _stacks(cfg):
        x, _ = _transformer_stack(params[key], x, cfg, yoco, rt,
                                  cache=None if cache is None
                                  else cache[ckey],
                                  decode_pos=decode_pos, chunk_ctx=chunk_ctx,
                                  aux=aux)
    return x, cache


# ----------------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------------
def init_cache_tree(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                    device=None) -> dict:
    """One contiguous cache per layer, stacked over L (the static
    ``serve()`` path's): ``k``/``v`` (L, B, max_seq, Hkv, dh), MLA configs
    ``ckv``/``krope`` (L, B, max_seq, ·); stacked per :func:`_stacks`.
    ``device`` defaults to the card; with no card it raises unless the
    caller passes ``device='cpu'``. Recurrent configs: f32 ``ssm`` state
    per Mamba2 layer, and a hybrid's ``attn`` caches per site."""
    _check_served(cfg)
    from repro_torch.runtime import layouts
    if _recurrent(cfg):
        tree = dict(ssm=_recurrent_states(cfg, batch, device))
        if cfg.hybrid_group:
            tree['attn'] = layouts.stack_layers(attn_mod.init_cache(
                cfg, batch, max_seq, dtype=dtype, device=device),
                _n_sites(cfg))
        return tree
    return {ckey: layouts.stack_layers(attn_mod.init_cache(
                cfg, batch, max_seq, dtype=dtype, device=device), n)
            for _, ckey, n, _ in _stacks(cfg)}


def _recurrent_states(cfg, batch: int, device) -> dict:
    """Zeroed f32 recurrent state per Mamba2 layer, stacked over them (the
    decay recurrence compounds rounding token over token, so serving
    keeps it f32 in every mode, as the reference does)."""
    from repro_torch.runtime import layouts
    return layouts.stack_layers(ssm_mod.init_ssm_state(
        cfg, batch, device=device_mod.resolve(device)), _n_mamba(cfg))


def init_paged_cache_tree(cfg, batch: int, *, num_pages: int, page_size: int,
                          max_blocks: int, dtype=torch.bfloat16,
                          kv_dtype: Optional[str] = None, hot_window: int = 1,
                          device=None, tp: int = 1) -> dict:
    """One physical pool pair per layer (stacked over L; MLA configs: one
    latent pool ``cl``) and one set of block tables broadcast per layer (a
    view; ``with_block_tables`` refreshes it). ``kv_dtype='int8'`` adds
    the int8 cold tier per layer (``kq``/``vq`` (L, P, ps, Hkv, dh),
    ``ks``/``vs`` (L, P, Hkv) f32; MLA: ``clq`` (L, P, ps, r + d_rope),
    ``cs`` (L, P, 1)) and the hot window ``hw``, a (1,) int32 broadcast
    per layer like ``bt``. Stacked per :func:`_stacks` (a
    ``first_k_dense`` MoE config: ``prefix`` and ``moe``).
    ``device`` defaults to the card; with no card it raises unless the
    caller passes ``device='cpu'``. ``tp`` > 1: a head-parallel serving
    rank's part, the GQA pools, their int8 tiers and per-head scales
    allocated at Hkv / tp (``layouts.stack_layers``; only one layer's
    template is ever whole), everything else whole.

    Recurrent configs get f32 ``ssm`` state per Mamba2 layer
    (``layouts.RecurrentLayout``: no positional axis; the scheduler's page
    accounting is then virtual) and a hybrid the sites' paged ``attn``
    pools (``layouts.HybridLayout``). Recurrent state has no int8 tier:
    ``kv_dtype`` on a pure SSM raises (a hybrid tiers its sites only)."""
    _check_served(cfg)
    from repro_torch.runtime import layouts
    if _recurrent(cfg):
        if cfg.family == 'ssm' and kv_dtype is not None:
            raise ValueError(
                'recurrent state has no int8 tier; drop kv_dtype for '
                f'family={cfg.family!r}')
        tree = dict(ssm=_recurrent_states(cfg, batch, device))
        if cfg.hybrid_group:
            tree['attn'] = layouts.stack_layers(attn_mod.init_paged_cache(
                cfg, batch, num_pages=num_pages, page_size=page_size,
                max_blocks=max_blocks, dtype=dtype, kv_dtype=kv_dtype,
                hot_window=hot_window, device=device), _n_sites(cfg), tp)
        return tree
    return {ckey: layouts.stack_layers(attn_mod.init_paged_cache(
                cfg, batch, num_pages=num_pages, page_size=page_size,
                max_blocks=max_blocks, dtype=dtype, kv_dtype=kv_dtype,
                hot_window=hot_window, device=device), n, tp)
            for _, ckey, n, _ in _stacks(cfg)}


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------
def _sharded_rt(rt: ModelRuntime, s: int) -> ModelRuntime:
    """The anchors' role (the reference's ``_constrain``): under
    act_layout '2d' a rank holds its 1/T of a sequence of ``s`` positions
    (T = the tp axis's size, where it divides s > 1), besides its dp block
    of the rows the step gave it."""
    t = rt.tp_size
    split = (rt.mesh is not None and rt.act_layout == '2d' and t > 1
             and s % t == 0 and s > 1)
    return dataclasses.replace(rt, seq_sharded=split) \
        if split != rt.seq_sharded else rt


def _seq_block(x: torch.Tensor, rt: ModelRuntime) -> torch.Tensor:
    """This rank's block of a (B, S, ...) tensor's sequence."""
    if not rt.seq_sharded:
        return x
    s = x.shape[1] // rt.tp_size
    o = rt.seq_offset(s)
    return x[:, o:o + s]


def forward(params: dict, batch: dict, cfg, yoco: YocoConfig = DEFAULT_YOCO,
            rt: ModelRuntime = DEFAULT_RT) -> Tuple[torch.Tensor, dict]:
    """Training forward: the causal logits at every position, (B, S, V)
    (codebooks: (B, S, CB, V)), and ``dict(moe_aux_loss=...)``, the sum of
    the MoE layers' load-balance losses in f32 (0 without MoE layers), in
    the autograd graph. On a rank mesh (``rt.mesh``) ``params`` are the
    blocks the train step computes on and ``batch`` the rank's rows: the
    logits are the rank's (its positions under '2d', its vocab block
    where the lm_head is cut)."""
    rt = _sharded_rt(rt, batch['inputs'].shape[1])
    x = _embed(params, _seq_block(batch['inputs'], rt), cfg, rt)
    aux = []
    x, _ = _backbone(params, x, cfg, yoco, rt, cache=None, decode_pos=None,
                     aux=aux)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco, rt), dict(moe_aux_loss=total)


def _nll(logits: torch.Tensor, labels: torch.Tensor, cfg,
         rt: ModelRuntime) -> torch.Tensor:
    """logsumexp minus the gold logit in f32, per position. Logits of a
    rank's vocab block (the 'tp' layout): the max and the sum of
    exponentials all-reduced over 'model', the gold logit taken from the
    rank that holds it."""
    lf = logits.to(torch.float32)
    v = lf.shape[-1]
    if lf.ndim == 3 and v < cfg.vocab_size:
        from repro_torch.distributed import collectives
        group = rt.model_group()
        m = collectives.all_reduce(lf.detach().amax(dim=-1), group,
                                   collectives.dist.ReduceOp.MAX)
        se = collectives.reduce_sum(
            torch.sum(torch.exp(lf - m[..., None]), dim=-1), group)
        local = labels - rt.mesh.index(rt.tp_axis) * v
        own = (local >= 0) & (local < v)
        g = torch.gather(lf, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        gold = collectives.reduce_sum(g * own.to(torch.float32), group)
        return m + torch.log(se) - gold
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    return logz - gold


def loss_fn(params: dict, batch: dict, cfg, yoco: YocoConfig = DEFAULT_YOCO,
            rt: ModelRuntime = DEFAULT_RT) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy in f32 (logsumexp minus the gold logit),
    averaged over the positions whose label is >= 0; an MoE config adds
    ``router_aux_weight * moe_aux_loss``. Returns (total, metrics with
    ``moe_aux_loss``, ``ce_loss``, ``total_loss`` and ``tokens``). On a
    rank mesh the mean is over every token of the mesh: the masked sum
    and the count summed over the axes the tokens are spread on, then
    divided (a mean of per-rank means would weigh ranks, not tokens)."""
    logits, metrics = forward(params, batch, cfg, yoco, rt)
    srt = _sharded_rt(rt, batch['inputs'].shape[1])
    labels = _seq_block(batch['labels'], srt).to(device=logits.device,
                                                   dtype=torch.int64)
    mask = (labels >= 0).to(torch.float32)
    nll = torch.sum(_nll(logits, labels, cfg, srt) * mask)
    tokens = torch.sum(mask)
    if srt.mesh is not None:
        from repro_torch.distributed import collectives
        group = srt.token_group()
        nll = collectives.reduce_sum(nll, group)
        tokens = collectives.all_reduce(tokens, group)
    loss = nll / torch.clamp_min(tokens, 1.0)
    total = loss
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_weight * metrics['moe_aux_loss']
    return total, dict(metrics, ce_loss=loss, total_loss=total,
                       tokens=tokens)


def prefill(params: dict, batch: dict, cache: dict, cfg,
            yoco: YocoConfig = DEFAULT_YOCO, rt: ModelRuntime = DEFAULT_RT,
            last_pos=None) -> Tuple[torch.Tensor, dict]:
    """Process the prompt ``batch['inputs']`` ((B, S) ids, (B, S, CB)
    codebook ids or (B, S, d) embeddings), fill the cache, return the
    logits ((B, V), or (B, CB, V)) at ``last_pos`` (B,) (default: the last
    position); Mamba2 layers mask the steps past ``last_pos``."""
    x = _embed(params, batch['inputs'], cfg, rt)
    x, cache = _backbone(params, x, cfg, yoco, rt, cache=cache,
                         decode_pos=None, last_pos=last_pos)
    if last_pos is None:
        x = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.int64,
                              device=x.device).reshape(-1)
        x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco, rt)[:, 0], cache


def prefill_chunk(params: dict, batch: dict, offset, limit, cache: dict, cfg,
                  yoco: YocoConfig = DEFAULT_YOCO,
                  rt: ModelRuntime = DEFAULT_RT) -> Tuple[torch.Tensor, dict]:
    """Process ONE C-token chunk of a longer prompt into a paged cache.

    ``batch['inputs']``: the chunk's (B, C) tokens; ``offset``/``limit``:
    (B,) int32 — the chunk covers absolute positions
    [offset, min(offset + C, limit)); rows past ``limit`` are padding
    (written to the garbage page). Earlier chunks and shared prefix pages
    are already in the cache, so chunk k attends [0, offset_k + C) as a
    monolithic prefill would. Returns the logits of the chunk row holding
    position ``limit - 1`` (meaningful on the final chunk only) and the
    cache."""
    x = _embed(params, batch['inputs'], cfg, rt)
    b, c = x.shape[:2]
    offset = torch.as_tensor(offset, dtype=torch.int32,
                             device=x.device).reshape(-1).expand(b)
    limit = torch.as_tensor(limit, dtype=torch.int32,
                            device=x.device).reshape(-1).expand(b)
    x, cache = _backbone(params, x, cfg, yoco, rt, cache=cache,
                         decode_pos=None,
                         chunk_ctx=dict(offset=offset, limit=limit))
    idx = torch.clamp(limit - 1 - offset, 0, c - 1).to(torch.int64)
    x = x[torch.arange(b, device=x.device), idx][:, None]
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco, rt)[:, 0], cache


def decode_step(params: dict, token: torch.Tensor, pos, cache: dict, cfg,
                yoco: YocoConfig = DEFAULT_YOCO,
                rt: ModelRuntime = DEFAULT_RT) -> Tuple[torch.Tensor, dict]:
    """One decode step: ``token`` (B,) ids, (B, CB) codebook ids or (B, d)
    embeddings; ``pos`` 0-d or (B,) positions."""
    x = _embed(params, token[:, None], cfg, rt)
    x, cache = _backbone(params, x, cfg, yoco, rt, cache=cache,
                         decode_pos=pos)
    x = apply_norm(params['final_norm'], x, cfg)
    return _head(params, x, cfg, yoco, rt)[:, 0], cache
