"""Analytical energy, latency and area model of the AiDAC/YOCO core (port
of ``repro/core/hwmodel.py``; paper Table I), and its decode-traffic
pricing.

Bottom-up from component numbers it gives the paper's headline figures:
4.235 nJ and < 20 ns per full-parallel 1024x256 8-bit VMM
(:func:`core_vmm_energy`, :func:`core_vmm_latency`), 123.8 TOPS/W and 26.2
TOPS (:func:`energy_efficiency_tops_w`, :func:`throughput_tops`), the area
(:func:`core_area_um2`), the 87.5% ADC-overhead cut
(:func:`adc_overhead_reduction`), the Fig. 7 SOTA comparison
(:func:`sota_comparison`) and the Fig. 8 breakdown
(:func:`overhead_breakdown`). :func:`map_matmul` tiles an (M, K, N) matmul
onto 1024x256 core-shots, and :func:`map_architecture` walks a config's
``per_token_matmuls`` to a per-decode-token cost.

:func:`decode_kv_traffic` (GQA) and :func:`decode_latent_traffic` (MLA)
price the bytes and pJ one decode token pays to read its KV cache: the fp
baseline against the hybrid int8/fp tier mix of ``runtime.kv_quant``,
through one core (:func:`_tiered_traffic`). ``cold_blocks=`` takes the
tier tracker's measured residency (the per-step entry point of
``runtime.telemetry.EnergyMeter``); ``None`` keeps the hotness rule's
steady-state split.

**These are modelled figures of the YOCO/AiDAC design, not measurements
of the card the port runs on.** The pJ constants are the paper's macro
model (Table I, residual-calibrated to its 4.235 nJ / 1024x256 8-bit VMM)
and commonly cited memory-system planning numbers (:class:`KVTierConfig`);
the H100 neither has an in-situ multiply array nor reports energy here.
Every function returns the reference's floats exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

# ----------------------------------------------------------------------------
# Table I: component parameters (28 nm, 0.9 V, 50 MHz analog, 1 GHz digital)
# ----------------------------------------------------------------------------
FJ = 1e-15
PJ = 1e-12
NS = 1e-9


@dataclasses.dataclass(frozen=True)
class CoreConfig:
    macro_rows: int = 128          # MCC rows per macro
    macro_cols: int = 256          # MCC columns per macro
    cb_bits: int = 8               # columns per compute block (weight bits)
    macros_v: int = 8              # vertically stacked (time-accumulated)
    macros_h: int = 8              # horizontally tiled (row-driver broadcast)
    # component energies
    mcc_energy_per_act: float = 0.81 * FJ
    row_driver_energy: float = 9.36 * FJ
    time_acc_energy: float = 58.5 * FJ
    tdc_energy: float = 7.7 * PJ
    io_energy_per_256b: float = 2.9 * PJ
    # component latencies
    macro_latency: float = 13.0 * NS          # phases I..V
    time_acc_latency: float = 113e-12         # per VTC hop
    tdc_latency: float = 0.9 * NS
    io_latency_per_256b: float = 0.112 * NS
    # component areas (um^2)
    mcc_area: float = 0.8
    row_driver_area: float = 0.18
    time_acc_area: float = 5.3
    tdc_area_total: float = 6865.0            # all 256 TDCs
    io_area: float = 4656.0
    # paper totals used to calibrate residuals
    paper_macro_energy: float = 29.6 * PJ     # @ 50% MCC activity
    paper_core_energy: float = 4235.0 * PJ
    paper_core_latency: float = 20.0 * NS
    paper_core_area_mm2: float = 18.5

    @property
    def vmm_k(self) -> int:       # input channels per core-shot
        return self.macro_rows * self.macros_v          # 1024

    @property
    def vmm_n(self) -> int:       # outputs per core-shot
        return (self.macro_cols // self.cb_bits) * self.macros_h  # 256

    @property
    def n_macros(self) -> int:
        return self.macros_v * self.macros_h            # 64

    @property
    def n_tdcs(self) -> int:
        return self.vmm_n                               # 256

    @property
    def cbs_per_macro(self) -> int:
        return self.macro_cols // self.cb_bits          # 32


DEFAULT_CORE = CoreConfig()


# ----------------------------------------------------------------------------
# Macro- and core-level energy (bottom-up, residual-calibrated)
# ----------------------------------------------------------------------------
def macro_energy(cfg: CoreConfig = DEFAULT_CORE,
                 activity: float = 0.5) -> Dict[str, float]:
    mcc = cfg.macro_rows * cfg.macro_cols * activity * cfg.mcc_energy_per_act
    drivers = cfg.macro_rows * cfg.row_driver_energy
    taccs = cfg.cbs_per_macro * cfg.time_acc_energy
    # Residual at the paper's reference activity (0.5): charging of the grouped
    # row capacitors during Phase I/II + S0..S4 switch drive.
    mcc_ref = cfg.macro_rows * cfg.macro_cols * 0.5 * cfg.mcc_energy_per_act
    other = cfg.paper_macro_energy - (mcc_ref + drivers + taccs)
    return dict(mcc=mcc, row_drivers=drivers, time_accumulators=taccs,
                macro_other=other,
                total=mcc + drivers + taccs + other)


def core_vmm_energy(cfg: CoreConfig = DEFAULT_CORE,
                    activity: float = 0.5) -> Dict[str, float]:
    """Energy of ONE full-parallel 1024x256 8-bit VMM on one core."""
    m = macro_energy(cfg, activity)
    macros = cfg.n_macros * m['total']
    tdcs = cfg.n_tdcs * cfg.tdc_energy
    in_bits = cfg.vmm_k * 8
    out_bits = cfg.vmm_n * 8
    io = (in_bits + out_bits) / 256.0 * cfg.io_energy_per_256b
    # Controller/decoder residual, calibrated at reference activity.
    m_ref = macro_energy(cfg, 0.5)
    control = cfg.paper_core_energy - (cfg.n_macros * m_ref['total'] + tdcs
                                       + io)
    total = macros + tdcs + io + control
    return dict(macros=macros, tdcs=tdcs, io=io, core_control=control,
                total=total,
                breakdown_macro=m)


def core_vmm_latency(cfg: CoreConfig = DEFAULT_CORE) -> Dict[str, float]:
    """Latency of one core-shot VMM (the <20 ns claim)."""
    chain = cfg.macros_v * cfg.time_acc_latency
    in_lat = (cfg.vmm_k * 8) / 256.0 * cfg.io_latency_per_256b
    out_lat = (cfg.vmm_n * 8) / 256.0 * cfg.io_latency_per_256b
    total = in_lat + cfg.macro_latency + chain + cfg.tdc_latency + out_lat
    return dict(io_in=in_lat, macro=cfg.macro_latency, vtc_chain=chain,
                tdc=cfg.tdc_latency, io_out=out_lat, total=total)


def core_area_um2(cfg: CoreConfig = DEFAULT_CORE) -> Dict[str, float]:
    mcc = cfg.macro_rows * cfg.macro_cols * cfg.mcc_area
    drv = cfg.macro_rows * cfg.row_driver_area
    tac = cfg.cbs_per_macro * cfg.time_acc_area
    macro = mcc + drv + tac
    total = cfg.n_macros * macro + cfg.tdc_area_total + cfg.io_area
    return dict(macro=macro, macros=cfg.n_macros * macro,
                tdcs=cfg.tdc_area_total, io=cfg.io_area, total=total)


# ----------------------------------------------------------------------------
# Headline figures
# ----------------------------------------------------------------------------
def ops_per_vmm(cfg: CoreConfig = DEFAULT_CORE) -> int:
    """Multiply and add each count as one op (paper §IV-B)."""
    return cfg.vmm_k * cfg.vmm_n * 2


def energy_efficiency_tops_w(cfg: CoreConfig = DEFAULT_CORE,
                             activity: float = 0.5) -> float:
    return ops_per_vmm(cfg) / core_vmm_energy(cfg, activity)['total'] / 1e12


def throughput_tops(cfg: CoreConfig = DEFAULT_CORE) -> float:
    # The paper quotes throughput against the 20 ns budget (one VMM per cycle
    # of the 50 MHz analog clock fits 20 ns).
    return ops_per_vmm(cfg) / cfg.paper_core_latency / 1e12


def adc_overhead_reduction(cfg: CoreConfig = DEFAULT_CORE) -> float:
    """Fig. 7b: against digital bit-plane weighting, which needs one
    conversion per bit-plane column (8 an output) instead of one an
    output: 1 - 1/8."""
    return 1.0 - 1.0 / cfg.cb_bits


def overhead_breakdown(cfg: CoreConfig = DEFAULT_CORE,
                       activity: float = 0.5) -> Dict[str, float]:
    """Fig. 8: the share of core energy by function."""
    e = core_vmm_energy(cfg, activity)
    m = e['breakdown_macro']
    n = cfg.n_macros
    total = e['total']
    return dict(
        compute=(m['mcc'] * n) / total,
        interconnect=((m['row_drivers'] + m['time_accumulators']) * n)
        / total,
        conversion=(e['tdcs'] + m['macro_other'] * n) / total,
        communication=e['io'] / total,
        control=e['core_control'] / total,
    )


# ----------------------------------------------------------------------------
# SOTA comparison (Fig. 1 / 6 / 7: values digitized from the paper's charts
# and the cited publications; 8-bit-equivalent numbers)
# ----------------------------------------------------------------------------
SOTA_BASELINES: List[Dict] = [
    dict(key='tu_isscc22', ref='[15]', kind='digital CIM', tops_w=36.5,
         tops=2.90),
    dict(key='jia_jssc22', ref='[16]', kind='programmable IMC', tops_w=30.0,
         tops=1.00),
    dict(key='wu_isscc22', ref='[17]', kind='time-domain CIM', tops_w=37.01,
         tops=1.241),
    dict(key='hsieh_isscc23', ref='[20]', kind='word-wise ACIM',
         tops_w=86.27, tops=1.80),
    dict(key='si_jssc21', ref='[9]', kind='6T LCC macro', tops_w=17.5,
         tops=0.060),
    dict(key='chen_capram', ref='[18]', kind='charge-domain 6T', tops_w=25.0,
         tops=0.030),
    dict(key='wang_sepwl', ref='[19]', kind='separate-WL 6T', tops_w=3.1,
         tops=0.176),
    dict(key='wang_c2c', ref='[7]', kind='C-2C ladder', tops_w=32.2,
         tops=0.100),
]


def sota_comparison(cfg: CoreConfig = DEFAULT_CORE) -> List[Dict]:
    ours_e = energy_efficiency_tops_w(cfg)
    ours_t = throughput_tops(cfg)
    return [dict(**b, energy_ratio=ours_e / b['tops_w'],
                 throughput_ratio=ours_t / b['tops'])
            for b in SOTA_BASELINES]


# ----------------------------------------------------------------------------
# Workload mapping
# ----------------------------------------------------------------------------
def map_matmul(m_tokens: int, k: int, n: int, cfg: CoreConfig = DEFAULT_CORE,
               n_cores: int = 1, activity: float = 0.5) -> Dict[str, float]:
    """Tile an (M x K) @ (K x N) matmul onto core-shots. A core-shot takes
    K <= 1024 inputs and gives N <= 256 outputs for one token; vertical
    K-tiles are time-accumulated inside a shot, but K > 1024 needs digital
    partial-sum adds (priced as one extra output readback a K-tile)."""
    k_tiles = math.ceil(k / cfg.vmm_k)
    n_tiles = math.ceil(n / cfg.vmm_n)
    shots = m_tokens * k_tiles * n_tiles
    e_shot = core_vmm_energy(cfg, activity)['total']
    extra_io = (k_tiles - 1) * n_tiles * m_tokens * (cfg.vmm_n * 8 / 256.0) \
        * cfg.io_energy_per_256b
    energy = shots * e_shot + extra_io
    latency = math.ceil(shots / n_cores) * cfg.paper_core_latency
    useful_ops = 2.0 * m_tokens * k * n
    return dict(shots=shots, energy=energy, latency=latency,
                useful_ops=useful_ops,
                utilization=useful_ops / (shots * ops_per_vmm(cfg)),
                effective_tops_w=useful_ops / energy / 1e12)


# ----------------------------------------------------------------------------
# Decode-attention KV traffic / energy: the hybrid ReRAM–SRAM tier model
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVTierConfig:
    """Energy constants for the tiered KV memory system (pJ/byte and
    TOPS/W; commonly-cited planning numbers, not Table I values — the
    paper's component model stops at the core boundary, this extends it to
    the memory system the serving stack actually exercises).

    * ``hbm_pj_per_byte``: HBM2E access ≈ 3.9 pJ/bit — the bulk ("ReRAM")
      tier, where cold int8 pages and the untiered baseline live.
    * ``sram_pj_per_byte``: large on-chip SRAM ≈ 0.15 pJ/bit — the hot
      ("SRAM") tier holding the last ``hot_window`` full-precision pages.
    * ``imc_tops_w``: 8-bit attention arithmetic on the YOCO/AiDAC array
      (the paper's 123.8 TOPS/W headline, ``energy_efficiency_tops_w``).
    * ``digital_tops_w``: bf16 digital attention arithmetic, the baseline
      the int8 tier is compared against.
    """
    hbm_pj_per_byte: float = 3.9 * 8
    sram_pj_per_byte: float = 0.15 * 8
    imc_tops_w: float = 123.8
    digital_tops_w: float = 10.0
    scale_bytes: int = 4              # f32 per-page, per-head absmax scales


DEFAULT_KV_TIER = KVTierConfig()


def decode_kv_traffic(s_live: int, *, n_heads: int, n_kv_heads: int,
                      head_dim: int, page_size: int, hot_window: int,
                      fp_bytes: int = 2,
                      tier: KVTierConfig = DEFAULT_KV_TIER,
                      cold_blocks: Optional[int] = None) -> Dict[str, float]:
    """Bytes and pJ one decode token pays to read its KV cache, fp baseline
    vs the hybrid int8/fp tier mix (``runtime.kv_quant``'s layout).

    Counts exactly what the paged flash kernels move: ``s_live`` positions
    of K and V (dead tiles are never fetched), plus one (Hkv,) scale vector
    per cold page per operand. ``fp_bytes`` is the hot/baseline element
    width (2 = bf16/fp16 serving pools, 4 = the f32 einsum oracle).

    Attention op count per generated token: QK^T and PV each do
    ``H * s_live * dh`` MACs = 2 ops, so ``4 * H * s_live * dh`` total.
    Baseline arithmetic is digital bf16; tiered arithmetic is the paper's
    8-bit in-situ multiply (cold tier operands are already int8 — the
    whole point of storing the bulk tier in the array's native precision).

    ``cold_blocks`` is the per-step incremental pricing entrypoint: pass
    the ``runtime.kv_quant.KVTierTracker``'s *actual* int8
    residency for the lane and it overrides the hotness-rule steady-state
    split — a freshly admitted lane prices all-hot until its pages age
    out, which is what its decode step really reads. ``None`` keeps the
    rule-derived split (the offline/benchmark default).
    """
    return _tiered_traffic(
        s_live, page_size=page_size, hot_window=hot_window,
        fp_bytes=fp_bytes, tier=tier, cold_blocks=cold_blocks,
        elems_per_block=page_size * n_kv_heads * head_dim * 2,  # K and V
        cold_scale_bytes_per_block=n_kv_heads * 2 * tier.scale_bytes,
        ops=4.0 * n_heads * s_live * head_dim)


def _tiered_traffic(s_live: int, *, page_size: int, hot_window: int,
                    fp_bytes: int, tier: KVTierConfig,
                    elems_per_block: int, cold_scale_bytes_per_block: float,
                    ops: float,
                    cold_blocks: Optional[int] = None) -> Dict[str, float]:
    """The one tier-pricing core behind :func:`decode_kv_traffic` and
    :func:`decode_latent_traffic`: hot/cold block split per the hotness
    rule (or the caller's measured ``cold_blocks`` residency), bytes per
    tier, and the memory+compute energy model. Layouts differ only in
    what one block carries (``elems_per_block``), the cold tier's
    per-page scale overhead, and the attention op count."""
    n_blocks = math.ceil(s_live / page_size)
    if cold_blocks is None:
        hot_blocks = min(max(hot_window, 1), n_blocks)
        cold_blocks = n_blocks - hot_blocks
    else:
        # measured residency: clamp to [0, n_blocks - 1] — the block being
        # written is always hot, mirroring hot_window >= 1
        cold_blocks = min(max(int(cold_blocks), 0), max(n_blocks - 1, 0))
        hot_blocks = n_blocks - cold_blocks
    hot_bytes = hot_blocks * elems_per_block * fp_bytes
    cold_bytes = cold_blocks * elems_per_block * 1 \
        + cold_blocks * cold_scale_bytes_per_block
    baseline_bytes = n_blocks * elems_per_block * fp_bytes
    # tiered: cold pages stream from the bulk tier, the hot window sits in
    # the precision tier; baseline: everything streams from bulk
    tiered_mem_pj = (cold_bytes * tier.hbm_pj_per_byte
                     + hot_bytes * tier.sram_pj_per_byte)
    baseline_mem_pj = baseline_bytes * tier.hbm_pj_per_byte
    tiered_compute_pj = ops / tier.imc_tops_w        # 1 TOPS/W == 1 op/pJ
    baseline_compute_pj = ops / tier.digital_tops_w
    tiered_pj = tiered_mem_pj + tiered_compute_pj
    baseline_pj = baseline_mem_pj + baseline_compute_pj
    return dict(
        s_live=s_live, n_blocks=n_blocks, hot_blocks=hot_blocks,
        cold_blocks=cold_blocks, fp_bytes=fp_bytes,
        hot_bytes_per_token=hot_bytes,
        cold_bytes_per_token=cold_bytes,
        tiered_bytes_per_token=hot_bytes + cold_bytes,
        baseline_bytes_per_token=baseline_bytes,
        bytes_reduction=baseline_bytes / max(hot_bytes + cold_bytes, 1),
        tiered_mem_pj=tiered_mem_pj, baseline_mem_pj=baseline_mem_pj,
        tiered_compute_pj=tiered_compute_pj,
        baseline_compute_pj=baseline_compute_pj,
        tiered_pj_per_token=tiered_pj, baseline_pj_per_token=baseline_pj,
        energy_reduction=baseline_pj / max(tiered_pj, 1e-12),
        ops_per_token=ops,
        tiered_tops_w=ops / max(tiered_pj, 1e-12),
        baseline_tops_w=ops / max(baseline_pj, 1e-12),
    )


def decode_latent_traffic(s_live: int, *, n_heads: int, latent_dim: int,
                          kv_lora_rank: int, page_size: int,
                          hot_window: int, fp_bytes: int = 2,
                          tier: KVTierConfig = DEFAULT_KV_TIER,
                          cold_blocks: Optional[int] = None
                          ) -> Dict[str, float]:
    """:func:`decode_kv_traffic` for the absorbed-MLA latent pool: bytes
    and pJ one decode token pays to read its latent cache, fp baseline vs
    the hybrid int8/fp tier mix (``runtime.layouts.PagedMLAQ8Layout``).

    Counts exactly what the paged MLA flash kernels move: each latent row
    (``latent_dim = r + d_rope`` values) is fetched ONCE and used twice
    (keys at full width, values at its first ``kv_lora_rank`` columns), so
    there is no K-and-V doubling; cold pages add ONE f32 per-page absmax
    scale (no per-head axis — the latent is shared by every head).

    Attention op count per generated token: the absorbed score is a
    ``latent_dim``-deep dot and the value reduction an ``r``-deep dot per
    head per position — ``2 * H * s_live * (latent_dim + r)`` MACs = 2 ops
    each.
    """
    out = _tiered_traffic(
        s_live, page_size=page_size, hot_window=hot_window,
        fp_bytes=fp_bytes, tier=tier, cold_blocks=cold_blocks,
        elems_per_block=page_size * latent_dim,       # fetched once
        cold_scale_bytes_per_block=tier.scale_bytes,  # one scale per page
        ops=2.0 * n_heads * s_live * (latent_dim + kv_lora_rank))
    return dict(out, latent_dim=latent_dim)


def decode_state_traffic(*, conv_elems: int, ssm_elems: int, n_heads: int,
                         n_layers: int, fp_bytes: int = 4,
                         tier: KVTierConfig = DEFAULT_KV_TIER
                         ) -> Dict[str, float]:
    """:func:`decode_kv_traffic` for recurrent (SSM) decode state: bytes
    and pJ one decode token pays to carry its per-slot state
    (``runtime.layouts.RecurrentLayout``: ``conv_elems`` + ``ssm_elems``
    values per layer, ``n_layers`` Mamba2 layers).

    Constant in sequence length: every layer reads the whole state and
    writes the whole new state back each token (2x the state bytes), and
    nothing ages, so the KV tiers' hot/cold split does not apply. The
    tiered column prices the design the layout leaves room for: the ssd
    state held int8 with one f32 absmax scale per head per layer, the
    small conv tail kept fp. ``fp_bytes`` defaults to 4: serving keeps
    recurrent state in f32.
    """
    per_layer_fp = (conv_elems + ssm_elems) * fp_bytes
    per_layer_tiered = (conv_elems * fp_bytes + ssm_elems * 1
                        + n_heads * tier.scale_bytes)
    baseline_bytes = 2.0 * n_layers * per_layer_fp       # read + write
    tiered_bytes = 2.0 * n_layers * per_layer_tiered
    # ssd update ops per token per layer: decay-multiply, outer-product
    # accumulate and output reduction each touch every state element
    ops = 6.0 * n_layers * ssm_elems
    baseline_pj = (baseline_bytes * tier.hbm_pj_per_byte
                   + ops / tier.digital_tops_w)
    tiered_pj = (tiered_bytes * tier.hbm_pj_per_byte
                 + ops / tier.imc_tops_w)
    return dict(
        conv_elems=conv_elems, ssm_elems=ssm_elems, n_layers=n_layers,
        fp_bytes=fp_bytes,
        state_bytes_resident=n_layers * per_layer_fp,
        baseline_bytes_per_token=baseline_bytes,
        tiered_bytes_per_token=tiered_bytes,
        bytes_reduction=baseline_bytes / max(tiered_bytes, 1),
        baseline_pj_per_token=baseline_pj,
        tiered_pj_per_token=tiered_pj,
        energy_reduction=baseline_pj / max(tiered_pj, 1e-12),
        ops_per_token=ops,
    )


def map_architecture(arch_cfg, cfg: CoreConfig = DEFAULT_CORE,
                     activity: float = 0.5,
                     target_tokens_per_s: float = 1e5) -> Dict[str, float]:
    """Per-decode-token AiDAC cost of a config (``repro_torch.configs``'
    ``ArchConfig``): every matmul of its ``per_token_matmuls`` mapped by
    :func:`map_matmul`; the embedding lookup is no VMM, the lm_head is
    one."""
    total_e = 0.0
    total_shots = 0
    useful = 0.0
    for _, kk, nn, cnt in arch_cfg.per_token_matmuls():
        r = map_matmul(1, kk, nn, cfg, activity=activity)
        total_e += r['energy'] * cnt
        total_shots += r['shots'] * cnt
        useful += r['useful_ops'] * cnt
    lat = total_shots * cfg.paper_core_latency   # single-core serial bound
    return dict(energy_per_token=total_e, shots_per_token=total_shots,
                useful_ops_per_token=useful,
                effective_tops_w=useful / total_e / 1e12,
                single_core_latency_per_token=lat,
                cores_for_target=math.ceil(target_tokens_per_s /
                                           (1.0 / lat)) if lat > 0 else 1,
                utilization=useful / (total_shots * ops_per_vmm(cfg)))
