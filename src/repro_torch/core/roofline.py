"""Roofline analysis for the dry-run cells on H100s (port of
``repro/core/roofline.py``).

Three terms per (arch x shape x mesh), all in seconds per step:

  compute    = HW_FLOPs   / (chips * PEAK_FLOPS)
  memory     = HBM_bytes  / HBM_BW                 [per device]
  collective = sum over the collectives a rank made, of their wire bytes
               over the link their group crosses    [per device]

FLOPs and HBM bytes are the reference's analytic model, unchanged: exact
for matmuls and documented for attention/SSD; MODEL_FLOPS is 6*N*D (dense)
/ 6*N_active*D (MoE) for training, and the HW/MODEL ratio exposes remat
recompute, MoE capacity padding and attention. The collective term reads
the dry run's own record (``launch/dryrun.py``): the bytes each collective
of one rank's step moved, by kind and by the mesh axes of its group
(``distributed/collectives.py::GROUP_BYTES``), each turned into ring wire
bytes and divided by its group's link.

The constants are the card's datasheet peaks, not measurements. Ranks sit
row-major on the mesh with 'model' fastest (``launch/mesh.py``), cards
``NODE_CARDS`` to an NVLink node in rank order, so a group whose ranks
span two nodes runs at the per-card network rate: on the production
meshes a 16-wide 'model' line spans two 8-card nodes and a 'data' line
sixteen, and every collective there is charged at ``NET_BW``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable

from repro_torch import configs

# NVIDIA H100 80GB HBM3, 700 W (SXM5) datasheet peaks, per card
PEAK_FLOPS_BF16 = 989.4e12        # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_INT8 = 1978.9e12       # dense int8 tensor-core OP/s
PEAK_FLOPS_F32 = 67e12            # f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12                  # device memory, bytes/s
# NVIDIA H100 80GB HBM3, 700 W: links
NVLINK_BW = 450e9                 # bytes/s a direction, inside a node
NET_BW = 50e9                     # bytes/s a card across nodes (400 Gb/s NDR)
NODE_CARDS = 8                    # cards an NVLink node

TRAIN_GRAD_ACCUM = 8              # must match launch.dryrun


def bound_s(nbytes: float, ops: float = 0.0,
            rate: float = PEAK_FLOPS_INT8) -> float:
    """A kernel's least time on the card, seconds: the larger of its bytes
    (each input read once, each output written once) over ``HBM_BW`` and
    its operations over ``rate`` (the peak of their type)."""
    return max(nbytes / HBM_BW, ops / rate)


# ---------------------------------------------------------------------------
# analytic FLOPs (the reference's, unchanged)
# ---------------------------------------------------------------------------
def matmul_flops_per_token(cfg, *, hw: bool = False) -> float:
    """2*K*N summed over every VMM one token passes through (active experts
    only). ``hw=True`` additionally charges the MoE capacity padding
    (dispatch buffers run E*C >= T*k tokens through the expert FFNs)."""
    total = 0.0
    for name, k, n, cnt in cfg.per_token_matmuls():
        f = 2.0 * k * n * cnt
        if hw and cfg.moe is not None and name.startswith('expert_'):
            f *= cfg.moe.capacity_factor
        total += f
    return total


def attention_flops_per_token(cfg, seq_len: int, *, decode: bool = False
                              ) -> float:
    """Score + AV contraction FLOPs per token per full pass (excluded from
    the 6ND MODEL_FLOPS convention; charged to HW_FLOPs)."""
    L = cfg.n_layers
    total = 0.0
    if cfg.family == 'ssm' or cfg.hybrid_group:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        h = d_inner // s.head_dim
        n_mamba = L if cfg.family == 'ssm' else L - L // cfg.hybrid_group
        if decode:
            per_tok = 4.0 * h * s.head_dim * s.d_state       # state update+out
        else:
            q = s.chunk_size
            per_tok = 2.0 * h * s.head_dim * (q + 2.0 * s.d_state)
        total += n_mamba * per_tok
        if cfg.family == 'ssm':
            return total
        n_attn = L // cfg.hybrid_group
    else:
        n_attn = L
    dh = cfg.resolved_head_dim
    h = cfg.n_heads
    if cfg.mla is not None:
        d_score = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        d_v = cfg.mla.v_head_dim
    else:
        d_score = d_v = dh
    for i in range(n_attn):
        s_eff = seq_len
        if cfg.sliding_window and cfg.local_global_every:
            is_global = (i % cfg.local_global_every) == \
                (cfg.local_global_every - 1)
            if not is_global:
                s_eff = min(seq_len, cfg.sliding_window)
        if decode:
            total += 2.0 * h * (d_score + d_v) * s_eff
        else:
            total += h * (d_score + d_v) * s_eff             # causal: S/2 * 2
    return total


@dataclasses.dataclass
class FlopsReport:
    model_flops: float      # assignment convention (global, per step)
    hw_flops: float         # what the hardware executes (global, per step)
    fwd_flops: float


def flops_for_cell(arch: str, shape_name: str, *, remat_full: bool = True
                   ) -> FlopsReport:
    cfg = configs.get(arch)
    sh = configs.SHAPES[shape_name]
    b, s = sh['global_batch'], sh['seq_len']
    if sh['kind'] == 'train':
        tokens = float(b) * s
        fwd = tokens * (matmul_flops_per_token(cfg, hw=True)
                        + attention_flops_per_token(cfg, s))
        hw = fwd * (4.0 if remat_full else 3.0)   # fwd + recompute + 2x bwd
        model = 6.0 * cfg.active_param_count() * tokens
        return FlopsReport(model, hw, fwd)
    if sh['kind'] == 'prefill':
        tokens = float(b) * s
        fwd = tokens * (matmul_flops_per_token(cfg, hw=True)
                        + attention_flops_per_token(cfg, s))
        model = 2.0 * cfg.active_param_count() * tokens
        return FlopsReport(model, fwd, fwd)
    # decode: one token per sequence against a seq_len cache
    tokens = float(b)
    fwd = tokens * (matmul_flops_per_token(cfg, hw=True)
                    + attention_flops_per_token(cfg, s, decode=True))
    model = 2.0 * cfg.active_param_count() * tokens
    return FlopsReport(model, fwd, fwd)


# ---------------------------------------------------------------------------
# analytic HBM bytes (per device, per step; the reference's cost model)
# ---------------------------------------------------------------------------
def cache_bytes(cfg, batch: int, seq: int, dtype_bytes: int = 2) -> float:
    """Global KV/state cache footprint."""
    L = cfg.n_layers
    if cfg.family == 'ssm' or cfg.hybrid_group:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        h = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        n_mamba = L if cfg.family == 'ssm' else L - L // cfg.hybrid_group
        total = n_mamba * batch * (h * s.head_dim * s.d_state * 4.0
                                   + (s.conv_width - 1) * conv_dim * 4.0)
        if cfg.family == 'ssm':
            return total
        sites = L // cfg.hybrid_group
        total += sites * batch * seq * 2 * cfg.n_kv_heads * \
            cfg.resolved_head_dim * dtype_bytes
        return total
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        return float(L) * batch * seq * per_tok * dtype_bytes
    return float(L) * batch * seq * 2 * cfg.n_kv_heads * \
        cfg.resolved_head_dim * dtype_bytes


def hbm_bytes_for_cell(arch: str, shape_name: str, chips: int,
                       grad_accum: int = TRAIN_GRAD_ACCUM) -> Dict[str, float]:
    """Per-device HBM traffic model (bytes/step). Components are returned
    so the dominant one can be attacked."""
    cfg = configs.get(arch)
    sh = configs.SHAPES[shape_name]
    b, s = sh['global_batch'], sh['seq_len']
    n_params = cfg.param_count()
    p_shard_bf16 = 2.0 * n_params / chips
    p_shard_f32 = 4.0 * n_params / chips
    d = cfg.d_model

    if sh['kind'] == 'train':
        a = grad_accum
        tokens_dev = float(b) * s / chips * 16  # dp shards only hold tokens:
        # tokens live on dp axes (chips/tp of them); tp=16 replicates
        # weight reads: fwd + remat recompute + bwd, per microbatch
        w_traffic = 3.0 * a * p_shard_bf16
        # grad-accum carry (f32) read+write per microbatch + opt update
        g_traffic = 2.0 * a * p_shard_f32 + 6.0 * p_shard_f32
        # residual-stream activations saved per layer (remat full)
        act = tokens_dev / a * d * cfg.n_layers * 2.0 * 3.0 * a
        logits = tokens_dev * (cfg.vocab_size / 16) * 4.0 * 2.0 \
            * cfg.n_codebooks
        total = w_traffic + g_traffic + act + logits
        return dict(weights=w_traffic, grads_opt=g_traffic, activations=act,
                    logits=logits, total=total)
    if sh['kind'] == 'prefill':
        tokens_dev = float(b) * s / chips * 16
        w = p_shard_bf16
        act = tokens_dev * d * cfg.n_layers * 2.0 * 2.0
        kv = cache_bytes(cfg, b, s) / chips
        total = w + act + kv
        return dict(weights=w, activations=act, cache_write=kv, total=total)
    # decode: weights once + cache read once
    w = 2.0 * cfg.active_param_count() / chips
    kv = cache_bytes(cfg, b, s) / chips
    total = w + kv
    return dict(weights=w, cache_read=kv, total=total)


# ---------------------------------------------------------------------------
# links and collectives
# ---------------------------------------------------------------------------
def _line_ranks(mesh_shape: Dict[str, int], axes: Iterable[str]) -> list:
    """The global ranks of rank 0's line along ``axes`` (row-major ranks,
    the last axis fastest)."""
    names = list(mesh_shape)
    axes = set(axes)
    strides, st = {}, 1
    for a in reversed(names):
        strides[a] = st
        st *= mesh_shape[a]
    ranks = [0]
    for a in names:
        if a in axes:
            ranks = [r + i * strides[a] for r in ranks
                     for i in range(mesh_shape[a])]
    return ranks


def crosses_nodes(mesh_shape: Dict[str, int], axes: Iterable[str]) -> bool:
    """Whether a group along ``axes`` holds cards of more than one
    ``NODE_CARDS``-card node."""
    return len({r // NODE_CARDS for r in _line_ranks(mesh_shape, axes)}) > 1


def link_bw(mesh_shape: Dict[str, int], axes: Iterable[str]) -> float:
    """The per-card rate of a group along ``axes``: NVLink inside a node,
    the network across nodes."""
    return NET_BW if crosses_nodes(mesh_shape, axes) else NVLINK_BW


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Ring wire bytes a device sends for one collective over ``g`` ranks,
    from the bytes ``distributed/collectives.py`` counts (the gathered
    result of an all-gather, the input of a reduce-scatter, the reduced
    tensor of an all-reduce, the exchanged tensor of an all-to-all): AG,
    RS and A2A move (g-1)/g of it, AR twice that."""
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    return nbytes * f * (2.0 if kind == 'all_reduce' else 1.0)


def collective_seconds(mesh_shape: Dict[str, int], by_axes: list) -> float:
    """Each entry of ``by_axes`` (dicts with ``kind``, ``axes``,
    ``bytes``) as wire bytes over its group's link, summed."""
    total = 0.0
    for e in by_axes:
        g = math.prod(mesh_shape[a] for a in e['axes'])
        total += wire_bytes(e['kind'], e['bytes'], g) / \
            link_bw(mesh_shape, e['axes'])
    return total


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------
def roofline_terms(arch: str, shape_name: str, record: dict,
                   *, int8: bool = False) -> Dict:
    """The three terms of one dry-run ``record`` (``launch/dryrun.py``),
    its dominant term and the step-time bound they give."""
    chips = record['n_chips']
    fl = flops_for_cell(arch, shape_name)
    hbm = hbm_bytes_for_cell(arch, shape_name, chips,
                             record.get('grad_accum', TRAIN_GRAD_ACCUM))
    peak = PEAK_FLOPS_INT8 if int8 else PEAK_FLOPS_BF16
    compute_s = fl.hw_flops / (chips * peak)
    memory_s = hbm['total'] / HBM_BW              # already per device
    collective_s = collective_seconds(record['mesh_shape'],
                                      record['collectives']['by_axes'])
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return dict(
        arch=arch, shape=shape_name, mesh=record['mesh'], chips=chips,
        **terms, dominant=dominant,
        step_time_lower_bound_s=bound,
        model_flops=fl.model_flops, hw_flops=fl.hw_flops,
        model_over_hw=fl.model_flops / fl.hw_flops,
        mfu_at_bound=fl.model_flops / (chips * PEAK_FLOPS_BF16) / bound,
        hbm_components=hbm,
        counted_flops=record['flops'],
        peak_mem_gib=record['memory']['peak_bytes'] / 2**30,
    )
