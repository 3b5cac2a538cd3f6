"""``yoco_linear`` — the paper's technique as a composable layer (port of
``repro/core/yoco_linear.py``). Every matmul of the model routes here.

Modes:

  bf16        digital baseline: ``x @ w`` in the compute dtype;
  qat         quantization-aware training: the activation fake-quantized
              per token and the weight per output channel (the codes and
              scales from kernel K3, dequantized with the reference's
              straight-through backward, ``quant.dequantize_ste``), then
              one ``torch.matmul`` in the compute dtype (the reference's
              ``jnp.matmul`` there is no Pallas kernel). A
              ``QuantizedWeight`` is dequantized to f32 and fake-quantized
              again, as in the reference;
  w8a8        YOCO inference: activations quantized ONCE per row (kernel K3;
              :func:`linears` shares that quantization between the weights
              that read one activation), int8 x int8 -> int32 with no
              mid-reduction rounding, ONE dequant. With a float weight
              (dynamic quantization) the weight's output channels go
              through K3 as well and the product is K4 with its fused scale
              epilogue (:func:`w8a8_ste`, whose backward is the reference's
              f32 straight-through one): serving stores that weight K-major
              at load (``models.model.k_major_linear_weights``), so K3 reads
              ``w.T`` in place and its (N, K) codes are K4's K-major
              operand; with a prequantized ``QuantizedWeight`` (int8
              weights resident, the in-situ analogue) the product is K2 and
              the epilogue ``acc * sx * w.scale`` follows it. On the card
              both kernels refuse a weight that is not K-major rather than
              copy it;
  analog_sim  the w8a8 product, then the paper-calibrated analog error
              model in f32 (:func:`analog_epilogue`: share-line gain loss,
              share-line and input noise, the per-K-tile VTC gain when K >
              1024, the ``tdc_bits`` TDC quantization), then the cast.

The reference routes w8a8 through its Pallas kernels only when
``use_pallas=True`` and through XLA otherwise; both compute the same
function. The port always goes through its kernels (``kernels/ops.py``): on
the card the hand-written CUDA kernels, on the CPU their plain versions.
The fake-quant dequantize, the analog noise and the TDC are plain ``jnp``
in the reference, outside any Pallas kernel, and plain torch here.

**The analog draws.** The reference draws each linear's noise from
``fold_in(key(noise_seed), K * 131 + N)``, so equal (K, N) means equal
noise (stablelm's ``wq``, ``wk`` and ``wv``). JAX's PRNG cannot be
reproduced, so the draws are a seam of their own: :func:`analog_normals`
seeds a ``torch.Generator`` on the output's device from ``(noise_seed,
K * 131 + N)`` on every call, and the noise is a pure function of
``(noise_seed, K, N, shape)`` as in the reference. The full scale ``max
|y|`` and the TDC scale are taken over the whole output, idle and padded
rows included, so a request's noise depends on what is batched beside it,
as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import analog, quant
from repro_torch.kernels import ops


class QuantizedWeight(NamedTuple):
    """int8 weight + per-out-channel scale: weights 'in situ'."""
    wq: torch.Tensor        # (..., K, N) int8, K-major (see k_major)
    scale: torch.Tensor     # (..., 1, N) f32


def k_major(wq: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values as a view of a (..., N, K)-contiguous
    tensor: each output column's K values are contiguous, the layout
    kernels K2 and K4 read (Hopper's 8-bit wgmma takes B only K-major).
    A tensor already K-major is returned uncopied."""
    return wq.transpose(-1, -2).contiguous().transpose(-1, -2)


#: f32 bytes of a column slice :func:`prequantize_weight` quantizes at once
PREQUANT_SLICE_BYTES = 1 << 28


def prequantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Per-out-channel scales; the contraction dim is axis -2. ``wq`` keeps
    the reference's (..., K, N) shape and values, stored K-major. The
    output columns are quantized a slice of at most
    ``PREQUANT_SLICE_BYTES`` of f32 at a time straight into the K-major
    codes: each column's scale reads only that column, so the result is
    the same, and the temporaries stay one slice wide (a 152064-wide
    lm_head's would be 5 GB each whole)."""
    *lead, k, n = w.shape
    keep = tuple(a for a in range(w.ndim) if a != w.ndim - 2)
    codes = torch.empty((*lead, n, k), dtype=torch.int8, device=w.device)
    sw = torch.empty((*lead, 1, n), dtype=torch.float32, device=w.device)
    step = max(1, PREQUANT_SLICE_BYTES // (4 * w[..., :1].numel()))
    for j in range(0, n, step):
        part = w[..., j:j + step]
        s = quant.absmax_scale(part, axis=keep)
        codes[..., j:j + step, :] = quant.quantize(part, s).transpose(-1, -2)
        sw[..., j:j + step] = s
    return QuantizedWeight(codes.transpose(-1, -2), sw)


@dataclasses.dataclass(frozen=True)
class YocoConfig:
    mode: str = 'bf16'              # bf16 | qat | w8a8 | analog_sim
    bits: int = 8
    tdc_bits: int = 8               # analog_sim output conversion width
    noise_seed: int = 0             # analog_sim draws (analog_normals)
    compute_dtype: torch.dtype = torch.bfloat16


DEFAULT_YOCO = YocoConfig()

MODES = ('bf16', 'qat', 'w8a8', 'analog_sim')


def _check_mode(cfg: YocoConfig) -> None:
    if cfg.mode not in MODES:
        raise ValueError(f'unknown yoco mode: {cfg.mode}')
    if cfg.mode != 'bf16' and cfg.bits != 8:
        raise NotImplementedError('the int8 kernels take bits=8 only')


# ----------------------------------------------------------------------------
# w8a8 forward with the straight-through backward
# ----------------------------------------------------------------------------
class _W8A8STE(torch.autograd.Function):
    """Forward: the dynamic w8a8 product from x's codes (K3, then K3 on
    the weight and K4). Backward: the reference's f32 ``dx = g @ w.T``,
    ``dw = x.T @ g``, as if the product were exact."""

    @staticmethod
    def forward(ctx, x, w, xq, sx):
        ctx.save_for_backward(x, w)
        return ops.yoco_vmm_codes(xq, sx, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        g2 = g.to(f32).reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1]).to(f32)
        dx = (g2 @ w.to(f32).t()).reshape(x.shape).to(x.dtype)
        dw = (x2.t() @ g2).to(w.dtype)
        return dx, dw, None, None


def w8a8_ste(x: torch.Tensor, w: torch.Tensor,
             codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
    """Dynamic w8a8 ``x @ w`` in f32 (port of the reference's
    ``_w8a8_ste``): ``codes`` are x's K3 codes and scales (made here when
    None). Through the straight-through backward where autograd asks for
    a gradient; serving builds no graph and calls the product directly."""
    xq, sx = ops.quantize_rows(x) if codes is None else codes
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _W8A8STE.apply(x, w, xq, sx)
    return ops.yoco_vmm_codes(xq, sx, w)


# ----------------------------------------------------------------------------
# analog_sim: the draws, then the noise epilogue
# ----------------------------------------------------------------------------
_NOISE_GENERATORS = {}


def analog_normals(noise_seed: int, word: int, shape, need_gain: bool,
                   device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The standard normals of one linear's noise: (n1, n2), n2 None unless
    ``need_gain``, drawn on ``device`` from a generator seeded from
    ``(noise_seed, word)`` on every call (``word = K * 131 + N``, the
    reference's ``fold_in`` argument), so equal arguments give equal
    draws."""
    device = torch.device(device)
    gen = _NOISE_GENERATORS.get(device)
    if gen is None:
        gen = _NOISE_GENERATORS[device] = torch.Generator(device=device)
    # the CPU generator keeps 32 bits of a seed: fold the noise seed into
    # them (a word is K * 131 + N, far below 2^32)
    gen.manual_seed((int(noise_seed) * 0x9E3779B1 + int(word)) % (1 << 32))

    def normal():
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)
    n1 = normal()
    return n1, (normal() if need_gain else None)


def analog_epilogue(y: torch.Tensor, k_channels: int, n_ktiles: int,
                    cfg: YocoConfig, n1: torch.Tensor,
                    n2: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's ``_analog_noise`` on the f32 product ``y``, given
    its draws: error relative to the per-tensor full scale ``max |y|``
    (kept a device scalar), term for term in the reference's order, then
    :func:`tdc_quantize`, whose scale is the compiled form, as the
    reference's jitted steps compute it."""
    em = analog.error_model_summary()
    fs = y.abs().amax() + 1e-9
    # deterministic share-line gain loss (Eq. 3 parasitics)
    y = y * (1.0 - em['mac_gain_loss'])
    # share-line kT/C and input-conversion noise folded over the channels;
    # the reference's jnp.sqrt of the Python number runs in f32
    rel = float(torch.sqrt(torch.tensor(
        em['mac_sigma_fs'] ** 2 + em['input_sigma_fs'] ** 2
        / max(k_channels, 1), dtype=torch.float32)))
    y = y + (fs * rel) * n1
    # time-domain accumulation: per-K-tile VTC gain error
    if n_ktiles > 1:
        y = y * (1.0 + em['time_sigma_fs'] * n2)
    # the TDC: the single output conversion
    return quant.dequantize(*tdc_quantize(y, cfg.tdc_bits))


def tdc_quantize(y: torch.Tensor, bits: int):
    """The analog output's ``bits``-bit TDC codes and their one per-tensor
    scale (the compiled form, ``quant.jit_absmax_scale``)."""
    scale = quant.jit_absmax_scale(y, None, bits)
    return quant.quantize(y, scale, bits), scale


def _analog(y: torch.Tensor, k: int, cfg: YocoConfig) -> torch.Tensor:
    # K-tiles: a macro's rows times the VTC chain's 8 macros (1024) a tile
    n_ktiles = -(-k // (analog.MACRO_ROWS * 8))
    n1, n2 = analog_normals(cfg.noise_seed, k * 131 + y.shape[-1],
                            tuple(y.shape), n_ktiles > 1, y.device)
    return analog_epilogue(y, k, n_ktiles, cfg, n1, n2)


# ----------------------------------------------------------------------------
# public layer
# ----------------------------------------------------------------------------
def _w8a8_product(x: torch.Tensor, codes, w, cfg: YocoConfig) -> torch.Tensor:
    """One w8a8 product in f32 from the activation's codes and scales
    (K3's). A ``QuantizedWeight`` (weights already int8 in memory): K2,
    then the reference's ``acc * sx * w.scale``. A float weight (dynamic
    quantization): :func:`w8a8_ste`, K3 on its output channels then K4.
    ``analog_sim`` adds the noise epilogue."""
    xq, sx = codes
    if isinstance(w, QuantizedWeight):
        y = ops.int8_matmul(xq, w.wq).to(torch.float32) * sx * w.scale
    else:
        y = w8a8_ste(x, w, codes)
    if cfg.mode == 'analog_sim':
        y = _analog(y, x.shape[-1], cfg)
    return y.to(cfg.compute_dtype)


def _float_weight(w) -> torch.Tensor:
    """A weight as a float (K, N): a ``QuantizedWeight`` dequantized to f32,
    as the reference's bf16 and qat modes read it."""
    if isinstance(w, QuantizedWeight):
        return quant.dequantize(w.wq, w.scale, torch.float32)
    return w


def _fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """``quant.fake_quant(w, axis=1)``: per-output-channel codes and
    scales from K3 on the rows of ``w.T`` (in place for a K-major
    weight), dequantized to w's dtype."""
    wq_t, sw_t = ops.quantize_rows(w.t())
    return quant.dequantize_ste(w, wq_t.t(), sw_t.t())


def linears(x: torch.Tensor, ws, bs=None,
            cfg: YocoConfig = DEFAULT_YOCO) -> list:
    """``[x @ w + b for w, b in zip(ws, bs)]`` under the configured mode, in
    the compute dtype (``bs`` None, or a list with None entries: no bias).
    Every mode but bf16 quantizes x ONCE (K3) for all the weights, as the
    reference's compiled step computes one quantization of an activation
    that several linears read (XLA merges the duplicates); bf16 runs one
    matmul a weight. Anything that runs several linears on one x uses this
    form: the q/k/v projections, an MLP's gate and up, MLA's w_dq and
    w_dkv."""
    _check_mode(cfg)
    cd = cfg.compute_dtype
    if cfg.mode == 'bf16':
        ys = [torch.matmul(x.to(cd), _float_weight(w).to(cd)) for w in ws]
    elif cfg.mode == 'qat':
        xq, sx = ops.quantize_rows(x)
        xf = quant.dequantize_ste(x, xq, sx).to(cd)
        ys = [torch.matmul(xf, _fake_quant_weight(_float_weight(w)).to(cd))
              for w in ws]
    else:
        codes = ops.quantize_rows(x)
        ys = [_w8a8_product(x, codes, w, cfg) for w in ws]
    bs = [None] * len(ws) if bs is None else bs
    return [y if b is None else y + b.to(y.dtype) for y, b in zip(ys, bs)]


def yoco_matmul(x: torch.Tensor, w: Union[torch.Tensor, QuantizedWeight],
                cfg: YocoConfig = DEFAULT_YOCO) -> torch.Tensor:
    """(..., K) @ (K, N) under the configured mode; returns compute dtype."""
    return linears(x, [w], cfg=cfg)[0]


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           cfg: YocoConfig = DEFAULT_YOCO) -> torch.Tensor:
    return linears(x, [w], [b], cfg)[0]


_WEIGHT_NAMES = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down', 'w_in',
                 'w_out', 'sh_gate', 'sh_up', 'sh_in', 'sh_down', 'sh_out',
                 'w_dq', 'w_uq', 'w_dkv', 'w_ukv', 'in_proj', 'out_proj',
                 'lm_head')


def is_linear_weight(name: str, leaf) -> bool:
    """A float (K, N) weight that the linears read, by parameter NAME as in
    the reference (biases, norms and embeddings are not)."""
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.ndim == 2 and name in _WEIGHT_NAMES)


def quantize_leaf(name: str, leaf, mult: int = 1, min_size: int = 1024,
                  under_moe: bool = False):
    """``quantize_tree``'s rule for one leaf: a linear weight of at least
    ``min_size`` values (``mult`` stacked copies counted) becomes a
    QuantizedWeight, a leaf under an MoE's experts and anything else stays
    as it is."""
    if (is_linear_weight(name, leaf) and leaf.numel() * mult >= min_size
            and not (under_moe and name in ('w_gate', 'w_up', 'w_down',
                                            'w_in', 'w_out'))):
        return prequantize_weight(leaf)
    return leaf


def quantize_tree(params, min_size: int = 1024):
    """Convert every linear weight into a QuantizedWeight — the 'load the
    network into the array' step for serving. Dispatch is by parameter
    NAME, as in the reference (biases, norms and embeddings stay float).
    The port keeps layers as a list of per-layer dicts; a weight inside that
    list counts ``len(list) * numel`` against ``min_size``, which is the size
    the reference sees on its stacked (L, K, N) leaf."""
    def conv(name, leaf, mult, under_moe):
        out = quantize_leaf(name, leaf, mult, min_size, under_moe)
        return out if out is not leaf else walk(leaf, name, mult, under_moe)

    def walk(node, name, mult, under_moe):
        if isinstance(node, dict):
            moe = under_moe or name == 'moe'
            return {k: conv(k, v, mult, moe) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, len(node), under_moe) for v in node]
        return node

    return walk(params, '', 1, False)


# ----------------------------------------------------------------------------
# a rank's column and row blocks (tensor parallelism)
# ----------------------------------------------------------------------------
def weight_shape(w) -> torch.Size:
    """A linear weight's (K, N), a ``QuantizedWeight``'s that of its
    codes."""
    return (w.wq if isinstance(w, QuantizedWeight) else w).shape


def _pad_columns(w: torch.Tensor, rank: int, ways: int) -> torch.Tensor:
    """A (K, N / ways) column block in its place among zeros, (K, N)."""
    n = w.shape[-1]
    parts = [w.new_zeros(w.shape[:-1] + (n * rank,)), w,
             w.new_zeros(w.shape[:-1] + (n * (ways - rank - 1),))]
    return torch.cat(parts, dim=-1)


def column_linears(x: torch.Tensor, ws, bs=None,
                   cfg: YocoConfig = DEFAULT_YOCO, *, rank: int = 0,
                   ways: int = 1) -> list:
    """:func:`linears` on a rank's column blocks ``ws`` (each the rank's
    1/ways of a weight's output columns). On the CPU the float products
    (bf16, qat) run at the whole width, each block among zeros, and the
    rank's columns are taken back: oneDNN picks another bf16 GEMM at N /
    ways columns than at N (at 128 rows and K = N = 2048 it sums in another
    order), and the whole-width product keeps a rank's columns bit-equal
    to one device's. The int8 products are exact at any width, and the
    card's cuBLAS products were checked equal per rank."""
    if (ways == 1 or x.device.type != 'cpu'
            or cfg.mode not in ('bf16', 'qat')):
        return linears(x, ws, bs, cfg)
    ys = linears(x, [_pad_columns(_float_weight(w), rank, ways)
                     for w in ws], None, cfg)
    bs = [None] * len(ws) if bs is None else bs
    out = []
    for y, w, b in zip(ys, ws, bs):
        n = w.shape[-1]
        y = y[..., rank * n:(rank + 1) * n]
        out.append(y if b is None else y + b.to(y.dtype))
    return out


def _codes_at(x2: torch.Tensor, amax: torch.Tensor):
    """K3's codes and scales of the rows of ``x2`` (M, K) as if each row
    held ``amax`` (M,) (>= its own absmax, a value of x2's dtype): the row
    extended by that value, quantized, the extension dropped. A row block
    of a wider row thus gets the whole row's codes."""
    ext = torch.cat([x2, amax.to(x2.dtype)[:, None]], dim=1)
    q, s = ops.quantize_rows(ext)
    return q[:, :x2.shape[1]], s


def _row_codes(x2: torch.Tensor, w: torch.Tensor, group):
    """The whole rows' K3 codes of a row block: x2 (M, K_loc) per row and
    w (K_loc, N) per output column, each scale from the absmax over the
    whole K (one all-reduce MAX of both absmax vectors over ``group``).
    Returns (xq (M, K_loc), sx (M, 1), wq (K_loc, N) K-major, sw (1, N))."""
    from repro_torch.distributed import collectives
    m = x2.shape[0]
    wt = w.t()                                  # (N, K_loc), in place
    amax = torch.cat([x2.abs().amax(dim=1).to(torch.float32),
                      wt.abs().amax(dim=1).to(torch.float32)])
    amax = collectives.all_reduce(amax, group,
                                  collectives.dist.ReduceOp.MAX)
    xq, sx = _codes_at(x2, amax[:m])
    wq_t, sw_t = _codes_at(wt, amax[m:])
    return xq, sx, wq_t.contiguous().t(), sw_t.reshape(1, -1)


class _RowW8A8(torch.autograd.Function):
    """A row block's dynamic w8a8 product, summed over the group: the
    whole rows' codes (:func:`_row_codes`), K2's int32 accumulators of the
    block, their int32 all-reduce, then K4's epilogue ``acc * sx * sw`` in
    f32: the exact route, equal to one device's K4 on the whole row.
    Backward: the straight-through f32 products of the rank's block (its
    inputs' cotangents are its own)."""

    @staticmethod
    def forward(ctx, x, w, group):
        from repro_torch.distributed import collectives
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        xq, sx, wq, sw = _row_codes(x2, w, group)
        acc = collectives.all_reduce(ops.int8_matmul(xq, wq), group)
        y = acc.to(torch.float32) * sx * sw
        return y.reshape(x.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        g2 = g.to(f32).reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1]).to(f32)
        dx = (g2 @ w.to(f32).t()).reshape(x.shape).to(x.dtype)
        dw = (x2.t() @ g2).to(w.dtype)
        return dx, dw, None


def _row_quantized(x: torch.Tensor, w: QuantizedWeight,
                   group) -> torch.Tensor:
    """A prequantized row block's product summed over the group, f32:
    the activation's codes at the whole row's absmax (an all-reduce MAX),
    K2 on the block, the int32 accumulators all-reduced, then the
    epilogue."""
    from repro_torch.distributed import collectives
    x2 = x.reshape(-1, x.shape[-1])
    amax = collectives.all_reduce(x2.abs().amax(dim=1).to(torch.float32),
                                  group, collectives.dist.ReduceOp.MAX)
    xq, sx = _codes_at(x2, amax)
    acc = collectives.all_reduce(ops.int8_matmul(xq, w.wq), group)
    y = acc.to(torch.float32) * sx * w.scale
    return y.reshape(x.shape[:-1] + (w.wq.shape[-1],))


def row_linear(x: torch.Tensor, w: torch.Tensor,
               cfg: YocoConfig = DEFAULT_YOCO, *, group=None
               ) -> torch.Tensor:
    """``x @ w`` summed over ``group`` where each rank holds a row block
    (its 1/n of K: ``x`` (..., K/n), ``w`` (K/n, N)), replicated on every
    rank, in the compute dtype; backward the identity into each rank's
    block (Megatron's row-parallel linear). bf16: the block's product in
    the compute dtype, summed in f32. The quantized modes quantize with
    the whole row's scales, as one device computes them (an all-reduce
    MAX of the absmax): w8a8 sums K2's int32 accumulators before the
    epilogue (exact), qat its fake-quantized blocks' products in f32, and
    analog_sim applies its noise to the summed product at the whole
    K. A ``QuantizedWeight`` row block (its scales are the whole K's, so
    a block of the codes is exact) takes the activation's codes at the
    whole row's absmax and sums K2's int32 accumulators before the
    epilogue ``acc * sx * w.scale``, equal to one device's K2 on the
    whole row; bf16 and qat read it dequantized. Without a group:
    :func:`linear`."""
    from repro_torch.distributed import collectives
    if group is None:
        return linear(x, w, cfg=cfg)
    _check_mode(cfg)
    cd = cfg.compute_dtype
    n = collectives.dist.get_world_size(group)
    if isinstance(w, QuantizedWeight):
        if cfg.mode in ('w8a8', 'analog_sim'):
            y = _row_quantized(x, w, group)
            if cfg.mode == 'analog_sim':
                y = _analog(y, x.shape[-1] * n, cfg)
            return y.to(cd)
        w = _float_weight(w)
    if cfg.mode == 'bf16':
        y = torch.matmul(x.to(cd), _float_weight(w).to(cd))
        return collectives.reduce_sum(y.to(torch.float32), group).to(cd)
    if cfg.mode == 'qat':
        x2 = x.reshape(-1, x.shape[-1])
        xq, sx, wq, sw = _row_codes(x2.detach(), w.detach(), group)
        xf = quant.dequantize_ste(x2, xq, sx).to(cd)
        wf = quant.dequantize_ste(w, wq, sw).to(cd)
        y = torch.matmul(xf, wf).reshape(x.shape[:-1] + (w.shape[-1],))
        return collectives.reduce_sum(y.to(torch.float32), group).to(cd)
    y = _RowW8A8.apply(x, w, group)
    if cfg.mode == 'analog_sim':
        y = _analog(y, x.shape[-1] * n, cfg)
    return y.to(cd)
