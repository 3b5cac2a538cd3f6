"""Behavioral simulator of the AiDAC/YOCO analog pipeline (port of
``repro/core/analog.py``; paper §III, Fig. 4/5).

It works in the paper's native space: unsigned N-bit codes in, voltages
through the array, time signals across macros, unsigned codes out, with
the paper-calibrated non-idealities:

  stage                       mechanism                   non-ideality
  ----------------------------------------------------------------------
  input conversion (Eq. 2)    grouped row caps, charge    unit-cap mismatch,
                              share                       code-dependent bow,
                                                          thermal noise
  1-bit MAC (Eq. 3)           column charge share / M     share-line gain
                                                          loss, column
                                                          mismatch, kT/C noise
  CB recombination (Eq. 4)    column cap groups           group-ratio mismatch
  inter-macro accumulation    VTC chain (time domain)     per-VTC gain error
  output conversion           8-bit TDC                   quantization

Calibration targets (``tests/test_torch_analog.py``): INL/DNL of the input
transfer curve < 2 LSB, input-conversion 3-sigma < 1 LSB, 8-bit
128-channel MAC error <= 0.68% of full scale, time accumulation <= 0.11%,
total VMM error < 0.79%.

**The draws are apart from the arithmetic.** The reference threads JAX
keys through every stage; here :func:`sample_chip` draws a chip from a
``torch.Generator``, and each stage takes its standard-normal draws as a
tensor (``None``: an ideal circuit). :func:`analog_vmm` makes every draw
on the inputs' device from its ``generator`` (or takes a given ``chip``
and ``normals``) and then runs the stages. So the stages can be fed the
reference's own chip (:func:`chip_from_numpy`) and normals, and be held
to it term for term: each stage copies the reference's arithmetic in the
same order, as it runs eagerly (true divisions).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bitplane

# ----------------------------------------------------------------------------
# Circuit constants (paper §IV-A, Table I)
# ----------------------------------------------------------------------------
VDD = 0.9                       # V
NBITS = 8
LSB = VDD / (2 ** NBITS - 1)    # 3.529 mV; the paper quotes 3.52 mV
MACRO_ROWS = 128                # MCC rows per macro
MACRO_COLS = 256                # MCC columns per macro
CB_COLS = NBITS                 # columns per compute block (one a bit plane)
MACRO_CBS = MACRO_COLS // CB_COLS   # 32 compute blocks (outputs) per macro

# ----------------------------------------------------------------------------
# Non-ideality magnitudes (calibrated to the paper's Fig. 5 numbers)
# ----------------------------------------------------------------------------
SIGMA_VNOISE = 0.66e-3          # V; thermal + PVT on input conversion
SIGMA_UNIT_CAP = 0.01           # relative unit-capacitor mismatch
INL_BOW_LSB = 0.7               # deterministic bow from switch parasitics
MAC_GAIN_LOSS = 0.006           # share line: V_meas = (1 - a) V_ideal
SIGMA_MAC_NOISE = 0.4e-3        # V; kT/C + charge injection
SIGMA_VTC_GAIN = 0.00035        # per-VTC relative gain error
TDC_BITS = 8

_F32 = torch.float32


@dataclasses.dataclass
class ChipSample:
    """One Monte-Carlo instance of a chip's static mismatch."""
    row_group_err: torch.Tensor   # (rows, NBITS) input-conversion groups
    col_gain_err: torch.Tensor    # (cols,) column share-line gain
    cb_group_err: torch.Tensor    # (cbs, NBITS) CB recombination ratios
    vtc_gain_err: torch.Tensor    # (n_macros_v,) per-VTC gain


def _pow2(device) -> torch.Tensor:
    """The ideal group ratios 2^j, j < NBITS, in f32."""
    return 2.0 ** torch.arange(NBITS, dtype=_F32, device=device)


def sample_chip(generator: torch.Generator, rows: int = MACRO_ROWS,
                cbs: int = MACRO_CBS, n_macros_v: int = 8) -> ChipSample:
    """Draw a chip's mismatch from ``generator``, on its device. A group of
    2^j unit caps averages unit mismatch down by sqrt(2^j)."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=_F32,
                           device=dev)
    group_sigma = SIGMA_UNIT_CAP / torch.sqrt(_pow2(dev))
    return ChipSample(
        row_group_err=normal(rows, NBITS) * group_sigma,
        col_gain_err=normal(cbs * CB_COLS) * SIGMA_UNIT_CAP
        / float(torch.sqrt(torch.tensor(float(rows)))),
        cb_group_err=normal(cbs, NBITS) * group_sigma,
        vtc_gain_err=normal(n_macros_v) * SIGMA_VTC_GAIN)


def chip_from_numpy(chip, device) -> ChipSample:
    """A reference ``ChipSample`` (fields as arrays) on ``device``."""
    return ChipSample(**{
        f.name: torch.from_numpy(np.array(getattr(chip, f.name),
                                          dtype=np.float32)).to(device)
        for f in dataclasses.fields(ChipSample)})


# ----------------------------------------------------------------------------
# Stage 1: DAC-less input conversion (Eq. 2)
# ----------------------------------------------------------------------------
def input_conversion(codes: torch.Tensor, chip: Optional[ChipSample] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-capacitor charge-share conversion of unsigned codes (..., rows)
    in [0, 255] to volts of the same shape; ideal V = IN / (2^N - 1) * VDD.
    ``noise``: standard normals of that shape (thermal noise), or None."""
    codes = codes.to(torch.int32)
    shifts = torch.arange(NBITS, dtype=torch.int32, device=codes.device)
    bits = ((codes[..., None] >> shifts) & 1).to(_F32)
    cap_w = _pow2(codes.device)
    if chip is not None:
        cap_w = cap_w * (1.0 + chip.row_group_err)        # (rows, NBITS)
    num = (bits * cap_w).sum(dim=-1)
    den = cap_w.sum(dim=-1) + 0.0
    if chip is not None:
        v = num / (2 ** NBITS - 1) * (255.0 / den) * VDD
    else:
        v = num / (2 ** NBITS - 1) * VDD
    # deterministic bow: switch / parasitic INL, worst mid-scale
    x = codes.to(_F32) / (2 ** NBITS - 1)
    v = v + INL_BOW_LSB * LSB * torch.sin(math.pi * x)
    if noise is not None:
        v = v + SIGMA_VNOISE * noise
    return v


def input_conversion_ideal(codes: torch.Tensor) -> torch.Tensor:
    return codes.to(_F32) / (2 ** NBITS - 1) * VDD


# ----------------------------------------------------------------------------
# Stages 2 and 3: 1-bit MAC by column charge share (Eq. 3), CB recombine
# (Eq. 4)
# ----------------------------------------------------------------------------
def macro_mac(v_in: torch.Tensor, w_codes: torch.Tensor,
              chip: Optional[ChipSample] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One macro: (..., rows) input volts x (rows, cbs) unsigned 8-bit
    weights -> (..., cbs) compute-block volts. ``noise``: standard normals
    of the columns' shape (..., cbs, NBITS) (share-line noise), or None.

    Eq. 3: V_out^j = sum_i V_in_i * B_ij / M; Eq. 4: V_CB = sum_j 2^j
    V_out^j / (2^N - 1)."""
    rows = v_in.shape[-1]
    n = w_codes.shape[1]
    planes = bitplane.decompose_unsigned(w_codes, NBITS).to(_F32)
    v_cols = torch.einsum('...r,rcb->...cb', v_in, planes) / rows   # Eq. 3
    gain = 1.0 - MAC_GAIN_LOSS
    if chip is not None:
        col_gain = 1.0 + chip.col_gain_err[: n * NBITS]
        v_cols = v_cols * col_gain.reshape(n, NBITS)
    v_cols = v_cols * gain
    if noise is not None:
        v_cols = v_cols + SIGMA_MAC_NOISE * noise
    cap_w = _pow2(v_in.device)
    if chip is not None:
        cap_w = cap_w * (1.0 + chip.cb_group_err[:n])     # (cbs, NBITS)
        return ((v_cols * cap_w).sum(dim=-1) / cap_w.sum(dim=-1)
                * (_pow2(v_in.device).sum() / (2 ** NBITS - 1)))
    return (v_cols * cap_w).sum(dim=-1) / (2 ** NBITS - 1)          # Eq. 4


def macro_mac_ideal(codes: torch.Tensor,
                    w_codes: torch.Tensor) -> torch.Tensor:
    """The exact value Eq. 2-4 compute with perfect circuits (volts)."""
    rows = codes.shape[-1]
    acc = torch.einsum('...r,rc->...c', codes.to(_F32), w_codes.to(_F32))
    return acc / (2 ** NBITS - 1) ** 2 / rows * VDD


# ----------------------------------------------------------------------------
# Stages 4 and 5: inter-macro time accumulation, TDC
# ----------------------------------------------------------------------------
def time_accumulate(v_parts: torch.Tensor, chip: Optional[ChipSample] = None,
                    axis: int = 0) -> torch.Tensor:
    """VTC chain: each partial-sum voltage becomes a time increment, and
    the increments add along ``axis``; per-VTC gain mismatch is the 0.11%
    error."""
    if chip is None:
        return v_parts.sum(dim=axis)
    n = v_parts.shape[axis]
    shape = [1] * v_parts.ndim
    shape[axis] = n
    gain = (1.0 + chip.vtc_gain_err[:n]).reshape(shape)
    return (v_parts * gain).sum(dim=axis)


def tdc(t_signal: torch.Tensor, full_scale: float) -> torch.Tensor:
    """8-bit time-to-digital conversion, the single output conversion
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    code = torch.round(t_signal / full_scale * (2 ** TDC_BITS - 1))
    return torch.clamp(code, 0, 2 ** TDC_BITS - 1).to(torch.int32)


# ----------------------------------------------------------------------------
# Full pipeline: the analog VMM (Fig. 4d phases I..VI)
# ----------------------------------------------------------------------------
def vmm_draws(generator: torch.Generator, lead: Sequence[int], k: int,
              n: int):
    """Every draw of one :func:`analog_vmm` of x (*lead, k) and w (k, n),
    from ``generator`` on its device: the chip (``cbs = max(n, 32)``, one
    VTC a macro) and, for each of the ceil(k / 128) macros, the input
    conversion's normals (*lead, 128) then the MAC's (*lead, n, NBITS)."""
    n_macros = -(-k // MACRO_ROWS)
    chip = sample_chip(generator, cbs=max(n, MACRO_CBS),
                       n_macros_v=n_macros)
    normals = []
    for _ in range(n_macros):
        for shape in ((*lead, MACRO_ROWS), (*lead, n, NBITS)):
            normals.append(torch.randn(shape, generator=generator,
                                       dtype=_F32, device=generator.device))
    return chip, normals


def analog_vmm(x_codes: torch.Tensor, w_codes: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               return_volts: bool = False, *,
               chip: Optional[ChipSample] = None,
               normals: Optional[List[torch.Tensor]] = None):
    """All-analog VMM: unsigned x (..., K) @ unsigned w (K, N) -> int32
    codes (..., N). K is split into ceil(K / 128) vertically stacked
    macros whose CB outputs accumulate in the time domain, with one TDC
    conversion at the end (YOCO).

    With ``generator`` every draw is made from it (:func:`vmm_draws`, on
    its device, which must be the inputs'); else ``chip`` and ``normals``
    (2 a macro, in :func:`vmm_draws`' order) are used as given, and with
    neither the circuits are ideal (the oracle)."""
    *lead, k = x_codes.shape
    kw, n = w_codes.shape
    if k != kw:
        raise ValueError(f'analog_vmm: x has K={k}, w has K={kw}')
    if generator is not None:
        if chip is not None or normals is not None:
            raise ValueError('analog_vmm: give a generator or the draws, '
                             'not both')
        chip, normals = vmm_draws(generator, lead, k, n)
    n_macros = -(-k // MACRO_ROWS)
    pad = n_macros * MACRO_ROWS - k
    xp = F.pad(x_codes, (0, pad)).reshape(*lead, n_macros, MACRO_ROWS)
    wp = F.pad(w_codes, (0, 0, 0, pad)).reshape(n_macros, MACRO_ROWS, n)
    if normals is None:
        normals = [None] * (2 * n_macros)
    v_cbs = []
    for m in range(n_macros):
        v_in = input_conversion(xp[..., m, :], chip, normals[2 * m])
        v_cbs.append(macro_mac(v_in, wp[m], chip, normals[2 * m + 1]))
    t_sum = time_accumulate(torch.stack(v_cbs, dim=0), chip, axis=0)
    codes = tdc(t_sum, n_macros * VDD)             # the chain's full scale
    if return_volts:
        return codes, t_sum
    return codes


def analog_vmm_ideal_codes(x_codes: torch.Tensor,
                           w_codes: torch.Tensor) -> torch.Tensor:
    """The exact digital result on the TDC's 8-bit grid: what a perfect
    chip outputs, so that circuit error is told apart from the TDC's."""
    k = x_codes.shape[-1]
    n_macros = -(-k // MACRO_ROWS)
    acc = torch.einsum('...k,kn->...n', x_codes.to(_F32), w_codes.to(_F32))
    t_ideal = acc / (2 ** NBITS - 1) ** 2 / MACRO_ROWS * VDD
    return tdc(t_ideal, n_macros * VDD)


# ----------------------------------------------------------------------------
# Summary statistics: the network-level noise model
# ----------------------------------------------------------------------------
def error_model_summary() -> dict:
    """The relative-to-full-scale error components ``yoco_linear``'s
    ``analog_sim`` mode injects (paper §IV-B/C)."""
    return dict(
        mac_gain_loss=MAC_GAIN_LOSS,                 # deterministic
        mac_sigma_fs=SIGMA_MAC_NOISE / VDD,          # share-line noise
        input_sigma_fs=SIGMA_VNOISE / VDD,           # input conversion
        time_sigma_fs=SIGMA_VTC_GAIN,                # VTC chain
        tdc_bits=TDC_BITS,
        total_bound=0.0079,                          # paper: < 0.79% total
    )
