#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Phases, in order; any failure exits non-zero and prints no result:

1. build   — print the card's name and power limit, compile every CUDA
             kernel from ``src/repro_torch/csrc`` (one nvcc per source, all
             at once).
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the serving path's full-width shapes (int outputs and int8
             codes bit-exact; attention 1e-5 on f32 and on bf16 pools, since
             kernel and plain version both compute in f32 on the same pools,
             with a sliding window on half the slots; K5 on the rows below
             its limit, every row finite; K6 also bit-equal to K1 when the
             hot window covers the table, over poisoned int8 pools) and time
             kernel, plain version and, where one exists, the one PyTorch
             call computing the same function (device time of each call's
             kernels, from torch.profiler; CUDA events where the profiler
             records no device kernel, named in each row's ``timer``).
3. smoke   — the port's GPU path against its own CPU plain path on the smoke
             config in f32: prefill plus decode in all three modes, decode
             over the int8 tier (hot window 1), and a prefix hit served by
             chunked prefill; logits within 1e-4 and equal greedy tokens.
4. profile — the device busy share of a short full-width bf16 and
             w8a8 --prequantize serve under torch.profiler (None where the
             profiler records no device kernel).
5. serve   — continuous paged serving of stablelm-1.6b at the published
             width (random weights from a seed) in bf16, w8a8 --prequantize
             and dynamic w8a8, plus one bf16 run whose pool forces
             preemption; then bf16 and w8a8 --prequantize with the int8 KV
             tier (--kv-quant --hot-window 2), and a stream of 128-token
             prompts sharing a 96-token prefix served privately, with
             --prefix-cache --chunk-prefill 32, and with --prefix-cache
             --kv-quant --hot-window 2. Every request must finish, no lane
             may produce a non-finite logits row, and each kernel's launch
             counter must show the run went through it (K1 24 times per
             decode step, K6 in its place with the tier; K5 24 times per
             prefill chunk; K3 and K2 169 times per forward with
             --prequantize); the tier must quantize pages, and the prefix
             cache must hit on at least 15 of 16 admissions with fewer peak
             pages than the private run.

Prints a ``{"kernels": [...]}`` line, a ``{"serve": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Details (the full shape sweep, compiler
reports) go to ``build/chip_smoke.json``.

Usage: python3 chip_smoke.py (every phase runs, always).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, 'src')
OUT_DIR = os.path.join(HERE, 'build')

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor rate
ARCH = 'stablelm-1.6b'
LAYERS_FULL = 24
LINEARS_PER_FORWARD = 7 * LAYERS_FULL + 1      # q k v o gate up down + lm_head


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profiled_kernels(torch, fn, attempts=2):
    """``{kernel name: [device ms, calls]}`` of every device kernel ``fn()``
    launches, from ``torch.profiler``; empty when the profiler recorded no
    device kernel in any of ``attempts`` sessions (its device tracing does
    not always start)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    by_name = defaultdict(lambda: [0.0, 0])
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
                by_name[ev.name][1] += 1
        if by_name:
            break
    return dict(by_name)


def device_ms(torch, fn, iters=20, warmup=3):
    """``(ms, timer)`` of one call. With ``timer == 'profiler'``, the summed
    duration of every kernel the call launches over ``iters`` calls (CUDA
    events around one call would also count the host's launch latency,
    which dominates a kernel of a few microseconds). Where the profiler
    records no device kernel, ``timer == 'cuda_events'``: the time of
    ``iters`` back-to-back calls between two CUDA events, which includes
    host launch time where that exceeds the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    kernels = profiled_kernels(torch, calls)
    if kernels:
        return sum(v[0] for v in kernels.values()) / iters, 'profiler'
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    calls()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 'cuda_events'


def bound(nbytes: float, ops: float = 0.0, ops_rate: float = INT8_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ----------------------------------------------------------------------------
# phase 2: every kernel against its plain version at full-width shapes
# ----------------------------------------------------------------------------
def record_row(torch, rows, name, shape, err, tol, fn, plain, lib, nbytes,
               ops=0.0, ops_rate=INT8_OPS_PER_S, route='cuda', source='',
               replaces=''):
    """Hold one kernel case to its tolerance, then time the kernel, its
    plain version and the library call, and append the row."""
    check(err <= tol, f'{name} {shape}: max |kernel - plain| = {err} '
                      f'> {tol}')
    b_ms, b_by = bound(nbytes, ops, ops_rate)
    lib_ms = lib_timer = None
    if lib is not None:
        try:
            lib()
        except RuntimeError:
            lib = None          # the library call does not take this shape
    if lib is not None:
        lib_ms, lib_timer = device_ms(torch, lib)
    ms, timer = device_ms(torch, fn)
    plain_ms, plain_timer = device_ms(torch, plain)
    rows.append(dict(name=name, shape=shape, route=route, source=source,
                     replaces=replaces, max_abs_err=err, tol=tol,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms,
                     timer=dict(ms=timer, plain_ms=plain_timer,
                                library_ms=lib_timer)))


def kernel_phase(torch, kmods):
    fd, kq, ky, build = kmods
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(*args, **kw):
        record_row(torch, rows, *args, **kw)

    # K1: B=8 slots, Hkv=32, G=1, dh=64, page size 8, W=20 (128 + 32 tokens)
    b, hkv, g, dh, ps, w = 8, 32, 1, 64, 8, 20
    n_pages = 1 + b * w
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, w).to(torch.int32).contiguous()
    pos = torch.randint(1, w * ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0                       # an idle slot: pos 0 ...
    bt[0] = 0                        # ... against the garbage page
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    win[1::2] = 9                    # a sliding window on every odd slot
    check(bool(((pos - win + 1) // ps > 0).any()),
          'K1 case: no window starts past the first page')
    q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
    live_keys = int(torch.minimum(pos + 1, win).to(torch.int64).sum())
    # kernel and plain version both compute in f32 on the same pools, so
    # bf16 pools are held to the f32 tolerance
    for dt, tol in ((torch.bfloat16, 1e-5), (torch.float32, 1e-5)):
        kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        scale = 1.0 / dh ** 0.5
        got = fd.flash_decode_gqa_paged(q, kp, vp, pos, win, bt, scale=scale)
        want = fd.flash_decode_gqa_paged_plain(q, kp, vp, pos, win, bt,
                                               scale=scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), 'K1 output not finite')
        err = float((got - want).abs().max())
        nbytes = (2 * live_keys * hkv * dh * kp.element_size()
                  + 2 * q.numel() * 4)
        record('flash_decode_paged',
               dict(B=b, Hkv=hkv, G=g, dh=dh, page_size=ps, W=w,
                    pool=str(dt).replace('torch.', ''), live_keys=live_keys,
                    windowed_slots=int((win <= w * ps).sum())),
               err, tol,
               lambda: fd.flash_decode_gqa_paged(q, kp, vp, pos, win, bt,
                                                 scale=scale),
               lambda: fd.flash_decode_gqa_paged_plain(q, kp, vp, pos, win,
                                                       bt, scale=scale),
               None, nbytes, source='src/repro_torch/csrc/flash_decode.cu',
               replaces='src/repro/kernels/flash_decode.py:304')

    # K3 / K2 / K4 at the linears' shapes: M in {8 slots, 128-token prompt}
    kn = ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352))
    for m in (8, 128):
        for k, n in kn:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            x[0, :] = 0              # an all-zero row: scale 1e-8 / 127
            wf = torch.randn((k, n), generator=gen, device=dev)
            xq, sx = kq.quantize_rows(x)
            xq_p, sx_p = kq.quantize_rows_plain(x)
            torch.cuda.synchronize()
            check(bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)),
                  f'K3 ({m},{k}) bf16 not bit-exact')
            record('quantize_rows', dict(M=m, K=k, dtype='bfloat16'), 0.0,
                   0.0, lambda: kq.quantize_rows(x),
                   lambda: kq.quantize_rows_plain(x), None,
                   m * k * 2 + m * k + m * 4,
                   source='src/repro_torch/csrc/quantize.cu',
                   replaces='src/repro/kernels/quantize.py:35')
            wt = wf.t().contiguous()          # dynamic w8a8: rows of w.T
            wq_t, sw_t = kq.quantize_rows(wt)
            wq_tp, sw_tp = kq.quantize_rows_plain(wt)
            torch.cuda.synchronize()
            check(bool(torch.equal(wq_t, wq_tp) and torch.equal(sw_t, sw_tp)),
                  f'K3 ({n},{k}) f32 not bit-exact')
            if m == 8:
                record('quantize_rows', dict(M=n, K=k, dtype='float32'), 0.0,
                       0.0, lambda: kq.quantize_rows(wt),
                       lambda: kq.quantize_rows_plain(wt), None,
                       n * k * 4 + n * k + n * 4,
                       source='src/repro_torch/csrc/quantize.cu',
                       replaces='src/repro/kernels/quantize.py:35')
            wq = wq_t.t().contiguous()
            sw = sw_t.reshape(1, n).contiguous()
            acc = ky.int8_matmul(xq, wq)
            acc_p = ky.int8_matmul_plain(xq, wq)
            torch.cuda.synchronize()
            check(bool(torch.equal(acc, acc_p)),
                  f'K2 ({m},{k},{n}) not bit-exact')
            mm_bytes = m * k + k * n
            record('int8_matmul', dict(M=m, K=k, N=n), 0.0, 0.0,
                   lambda: ky.int8_matmul(xq, wq),
                   lambda: ky.int8_matmul_plain(xq, wq),
                   lambda: torch._int_mm(xq, wq),
                   mm_bytes + 4 * m * n, 2.0 * m * k * n,
                   source='src/repro_torch/csrc/yoco_vmm.cu',
                   replaces='src/repro/kernels/yoco_vmm.py:116')
            y = ky.yoco_vmm_int8(xq, wq, sx, sw)
            y_p = ky.yoco_vmm_int8_plain(xq, wq, sx, sw)
            torch.cuda.synchronize()
            check(bool(torch.equal(y, y_p)),
                  f'K4 ({m},{k},{n}) differs from its plain version')
            record('yoco_vmm_int8', dict(M=m, K=k, N=n), 0.0, 0.0,
                   lambda: ky.yoco_vmm_int8(xq, wq, sx, sw),
                   lambda: ky.yoco_vmm_int8_plain(xq, wq, sx, sw), None,
                   mm_bytes + 4 * (m + n) + 4 * m * n, 2.0 * m * k * n,
                   source='src/repro_torch/csrc/yoco_vmm.cu',
                   replaces='src/repro/kernels/yoco_vmm.py:65')
            del wf, wt, wq_t, wq_tp, wq, acc, acc_p, y, y_p
    return rows


def tier_chunk_kernel_phase(torch, kmods):
    """K6 (paged decode over the int8 tier) and K5 (chunked-prefill
    attention) against their plain versions at full-width shapes."""
    from repro_torch.runtime import kv_quant as kvq

    fd = kmods[0]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    src = 'src/repro_torch/csrc/flash_decode.cu'
    scale = 1.0 / 64 ** 0.5

    # K6: B=8, Hkv=32, G=1, dh=64, page size 8, W=20, hot window 2; one
    # idle slot, a 9-key window on every odd slot, three slots deep enough
    # for many cold pages; every page outside its hot window quantized
    b, hkv, g, dh, ps, w, hw = 8, 32, 1, 64, 8, 20, 2
    n_pages = 1 + b * w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = torch.randint(1, w * ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    bt[0] = 0
    pos[2], pos[4], pos[6] = w * ps - 1, 130, 97
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    win[1::2] = 9
    hwt = torch.tensor([hw], dtype=torch.int32, device=dev)
    q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
    pos_h, win_h, bt_h = pos.cpu().tolist(), win.cpu().tolist(), bt.cpu()
    cold = kvq.cold_page_list(bt_h, pos_h, ps, hw)
    check(len(cold) >= 30, f'K6 case has only {len(cold)} cold pages')
    for dt in (torch.bfloat16, torch.float32):
        c = dict(k=torch.randn((n_pages, ps, hkv, dh), generator=gen,
                               device=dev).to(dt),
                 v=torch.randn((n_pages, ps, hkv, dh), generator=gen,
                               device=dev).to(dt),
                 kq=torch.zeros((n_pages, ps, hkv, dh), dtype=torch.int8,
                                device=dev),
                 vq=torch.zeros((n_pages, ps, hkv, dh), dtype=torch.int8,
                                device=dev),
                 ks=torch.zeros((n_pages, hkv), device=dev),
                 vs=torch.zeros((n_pages, hkv), device=dev))
        kvq.quantize_pages_layer(c, torch.tensor(cold, device=dev))
        args = (q, c['k'], c['v'], c['kq'], c['vq'], c['ks'], c['vs'], pos,
                win, bt, hwt)
        got = fd.flash_decode_gqa_paged_q8(*args, scale=scale)
        want = fd.flash_decode_gqa_paged_q8_plain(*args, scale=scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), 'K6 output not finite')
        err = float((got - want).abs().max())
        # bytes: each live key from its one tier, a scale pair per cold
        # live page, q in and out
        elt = c['k'].element_size()
        nbytes = 2 * q.numel() * 4
        for p_, w_ in zip(pos_h, win_h):
            first_hot = max(p_, 0) // ps - hw + 1
            cold_pages = set()
            for kpos in range(max(p_ - w_ + 1, 0), p_ + 1):
                if kpos // ps >= first_hot:
                    nbytes += 2 * hkv * dh * elt
                else:
                    nbytes += 2 * hkv * dh
                    cold_pages.add(kpos // ps)
            nbytes += len(cold_pages) * 2 * hkv * 4
        live_keys = sum(min(p_ + 1, w_) for p_, w_ in zip(pos_h, win_h))
        record_row(torch, rows, 'flash_decode_paged_q8',
                   dict(B=b, Hkv=hkv, G=g, dh=dh, page_size=ps, W=w,
                        hot_window=hw, pool=str(dt).replace('torch.', ''),
                        cold_pages=len(cold), live_keys=live_keys,
                        windowed_slots=int((win <= w * ps).sum())),
                   err, 1e-5,
                   lambda: fd.flash_decode_gqa_paged_q8(*args, scale=scale),
                   lambda: fd.flash_decode_gqa_paged_q8_plain(*args,
                                                              scale=scale),
                   None, nbytes, source=src,
                   replaces='src/repro/kernels/flash_decode.py:475')
        # what the tier costs on the device: K1 over the same fp pools
        rows[-1]['k1_ms_same_inputs'], _ = device_ms(
            torch, lambda: fd.flash_decode_gqa_paged(q, c['k'], c['v'], pos,
                                                     win, bt, scale=scale))
        # a hot window covering the table never reads the int8 tier: K6 is
        # then bit-equal to K1, even over poisoned int8 pools
        c['kq'].fill_(127)
        c['vq'].fill_(-127)
        c['ks'].fill_(float('nan'))
        c['vs'].fill_(1e6)
        full = torch.tensor([w], dtype=torch.int32, device=dev)
        q8 = fd.flash_decode_gqa_paged_q8(q, c['k'], c['v'], c['kq'],
                                          c['vq'], c['ks'], c['vs'], pos,
                                          win, bt, full, scale=scale)
        k1 = fd.flash_decode_gqa_paged(q, c['k'], c['v'], pos, win, bt,
                                       scale=scale)
        torch.cuda.synchronize()
        check(bool(torch.equal(q8, k1)),
              f'K6 with hw >= W differs from K1 ({dt}): max '
              f'{float((q8 - k1).abs().max())}')
        rows[-1]['bit_equal_k1_at_full_hot_window'] = True

    # K5: one request, Hkv=32, G=1, dh=64, page size 8, W=20, limit 128:
    # C=32 at offsets 0 and 96 (a miss's first chunk, a prefix hit's
    # suffix at --chunk-prefill 32), C=8 at offsets 96 and 120 (the first
    # and last page-size chunk of a prefix hit's suffix, the chunk size
    # the prefix cache uses without --chunk-prefill) and an unaligned C=7
    # whose last 3 rows are padding
    b, w, limit = 1, 20, 128
    n_pages = 1 + w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        for c, off in ((32, 0), (32, 96), (8, 96), (8, 120), (7, 124)):
            qc = torch.randn((b, c, hkv * g, dh), generator=gen, device=dev)
            qg = qc.reshape(b, c, hkv, g, dh).permute(0, 2, 1, 3, 4) \
                .reshape(b, hkv, c * g, dh).contiguous()
            offv, posv, winv = fd._chunk_scalars(off, limit, None, b, c,
                                                 w * ps, dev)
            args = (qg, kp, vp, posv, winv, bt, offv)
            got = fd.flash_decode_gqa_paged(*args, scale=scale, chunk=c)
            want = fd.flash_decode_gqa_paged_plain(*args, scale=scale,
                                                   chunk=c)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'K5 C={c} offset={off}: output not finite')
            n_valid = min(c, limit - off)
            rowpos = off + torch.arange(c * g, device=dev) // g
            valid = rowpos < limit
            err = float((got - want)[:, :, valid].abs().max())
            pos_u = int(posv[0])
            live_keys = pos_u + 1               # no window: keys [0, pos]
            nbytes = (2 * live_keys * hkv * dh * kp.element_size()
                      + 2 * int(valid.sum()) * hkv * dh * 4)
            row_keys = sum(off + i + 1 for i in range(n_valid)) * g
            ops = 4.0 * hkv * dh * row_keys
            record_row(torch, rows, 'flash_chunk_paged',
                       dict(B=b, Hkv=hkv, G=g, dh=dh, page_size=ps, W=w,
                            C=c, offset=off, limit=limit,
                            pool=str(dt).replace('torch.', ''),
                            padding_rows=c - n_valid,
                            all_rows_max_abs_err=float(
                                (got - want).abs().max())),
                       err, 1e-5,
                       lambda: fd.flash_decode_gqa_paged(*args, scale=scale,
                                                         chunk=c),
                       lambda: fd.flash_decode_gqa_paged_plain(
                           *args, scale=scale, chunk=c),
                       None, nbytes, ops, BF16_OPS_PER_S, source=src,
                       replaces='src/repro/kernels/flash_decode.py:304')
    return rows


# ----------------------------------------------------------------------------
# phase 3: GPU path vs the CPU plain path, smoke config, f32
# ----------------------------------------------------------------------------
def smoke_phase(torch):
    from repro_torch import configs
    from repro_torch.core import yoco_linear
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import kv_cache as kvc
    from repro_torch.runtime import layouts

    cfg = configs.get(ARCH, smoke=True)
    f32 = torch.float32
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')
    b, plen, steps, ps = 4, 12, 8, 4
    max_blocks = -(-(plen + steps) // ps)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen)
    results = []
    for mode, prequant in (('bf16', False), ('w8a8', True), ('w8a8', False)):
        yoco = YocoConfig(mode=mode, compute_dtype=f32)
        rt = M.ModelRuntime(attn_impl='flash', compute_dtype=f32)
        host = yoco_linear.quantize_tree(base) if prequant else base
        runs = {}
        for dev in ('cpu', 'cuda'):
            params = _to(host, dev)
            kv = kvc.PagedKVCache(1 + b * max_blocks, ps, max_blocks, b)
            cache = M.init_paged_cache_tree(
                cfg, b, num_pages=1 + b * max_blocks, page_size=ps,
                max_blocks=max_blocks, dtype=f32, device=dev)
            for s in range(b):
                kv.alloc_blocks(s, max_blocks)
            cache = layouts.with_block_tables(cache, kv.tables)
            logits, cache = M.prefill(params, dict(inputs=prompts.to(dev)),
                                      cache, cfg, yoco, rt)
            rows, toks = [logits.cpu()], []
            tok = torch.argmax(logits, -1)
            for i in range(steps):
                toks.append(tok.cpu())
                pos = torch.full((b,), plen + i, dtype=torch.int32, device=dev)
                logits, cache = M.decode_step(params, tok, pos, cache, cfg,
                                              yoco, rt)
                rows.append(logits.cpu())
                tok = torch.argmax(logits, -1)
            runs[dev] = (torch.stack(rows), torch.stack(toks))
        err = float((runs['cpu'][0] - runs['cuda'][0]).abs().max())
        check(err <= 1e-4, f'smoke {mode} prequant={prequant}: GPU vs CPU '
                           f'logits differ by {err} > 1e-4')
        check(bool(torch.equal(runs['cpu'][1], runs['cuda'][1])),
              f'smoke {mode} prequant={prequant}: greedy tokens differ')
        results.append(dict(mode=mode, prequantize=prequant,
                            max_abs_logit_err=err, tol=1e-4))
    return results


def smoke_tier_prefix_phase(torch):
    """The slice-2 paths on the smoke config in f32, GPU against CPU:
    decode over the int8 tier with hot window 1 (K6; aged-out pages
    quantized before each step), and a prefix hit whose unshared suffix is
    prefilled in chunks (K5) and then decoded beside its donor (K1)."""
    from repro_torch import configs
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import kv_cache as kvc
    from repro_torch.runtime import kv_quant as kvq
    from repro_torch.runtime import layouts

    cfg = configs.get(ARCH, smoke=True)
    f32 = torch.float32
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')
    yoco = YocoConfig(mode='bf16', compute_dtype=f32)
    rt = M.ModelRuntime(attn_impl='flash', compute_dtype=f32)
    gen = torch.Generator().manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen)
    suffix = torch.randint(0, cfg.vocab_size, (5,), generator=gen)

    def tier_run(dev):
        b, plen, steps, ps = 4, 12, 8, 4
        w = -(-(plen + steps) // ps)
        params = _to(base, dev)
        kv = kvc.PagedKVCache(1 + b * w, ps, w, b)
        for s in range(b):
            kv.alloc_blocks(s, w)
        cache = M.init_paged_cache_tree(cfg, b, num_pages=1 + b * w,
                                        page_size=ps, max_blocks=w,
                                        dtype=f32, kv_dtype='int8',
                                        hot_window=1, device=dev)
        cache = layouts.with_block_tables(cache, kv.tables)
        tier = kvq.KVTierTracker(1, ps)
        logits, cache = M.prefill(params, dict(inputs=prompts.to(dev)),
                                  cache, cfg, yoco, rt)
        rows, toks, quantized = [logits.cpu()], [], 0
        tok = torch.argmax(logits, -1)
        for i in range(steps):
            toks.append(tok.cpu())
            pages = [p for s in range(b)
                     for p in tier.aged_out(s, plen + i, kv.tables[s])]
            if pages:
                quantized += len(pages)
                cache = kvq.quantize_tree_pages(
                    cache, torch.tensor(pages, device=dev))
            pos = torch.full((b,), plen + i, dtype=torch.int32, device=dev)
            logits, cache = M.decode_step(params, tok, pos, cache, cfg,
                                          yoco, rt)
            rows.append(logits.cpu())
            tok = torch.argmax(logits, -1)
        check(quantized > 0, 'smoke tier run quantized no page')
        return torch.stack(rows), torch.stack(toks)

    def prefix_run(dev):
        ps, w, steps, c = 4, 5, 6, 4
        params = _to(base, dev)
        donor = prompts[0].numpy()
        hit = np.concatenate([donor[:8], suffix.numpy()])
        kv = kvc.PagedKVCache(1 + 2 * w, ps, w, 2, prefix_cache=True)
        cache = M.init_paged_cache_tree(cfg, 2, num_pages=1 + 2 * w,
                                        page_size=ps, max_blocks=w,
                                        dtype=f32, device=dev)
        check(not kv.admit_prompt(0, donor)['hit'], 'smoke donor hit')
        part = layouts.with_block_tables(cache, kv.tables[0:1])
        logits, _ = M.prefill(params, dict(inputs=prompts[:1].to(dev)), part,
                              cfg, yoco, rt)
        kv.seal_slot(0, donor)
        rows = [logits.cpu()]
        plan = kv.admit_prompt(1, hit)
        check(plan['hit'] and plan['shared'] == 2
              and plan['prefill_start'] == 8, f'smoke prefix plan {plan}')
        part = layouts.with_block_tables(cache, kv.tables[1:2])
        lim = torch.tensor([len(hit)], dtype=torch.int32, device=dev)
        for off in range(plan['prefill_start'], len(hit), c):
            ck = np.zeros((1, c), np.int64)
            ck[0, :len(hit[off:off + c])] = hit[off:off + c]
            logits, _ = M.prefill_chunk(
                params, dict(inputs=torch.from_numpy(ck).to(dev)),
                torch.tensor([off], dtype=torch.int32, device=dev), lim,
                part, cfg, yoco, rt)
        rows.append(logits.cpu())
        tok = torch.cat([torch.argmax(r, -1) for r in rows]).to(dev)
        pos = np.array([len(donor), len(hit)])
        toks = []
        for i in range(steps):
            toks.append(tok.cpu())
            for s in range(2):
                check(kv.ensure(s, int(pos[s]) + i), 'smoke pool dry')
            cache = layouts.with_block_tables(cache, kv.tables)
            logits, cache = M.decode_step(
                params, tok, torch.from_numpy(pos + i).to(torch.int32)
                .to(dev), cache, cfg, yoco, rt)
            rows.append(logits.cpu())
            tok = torch.argmax(logits, -1)
        return torch.cat(rows), torch.stack(toks)

    results = []
    for name, fn in (('kv_quant hot_window=1', tier_run),
                     ('prefix hit, chunked prefill C=4', prefix_run)):
        cpu, gpu = fn('cpu'), fn('cuda')
        err = float((cpu[0] - gpu[0]).abs().max())
        check(err <= 1e-4, f'smoke {name}: GPU vs CPU logits differ by '
                           f'{err} > 1e-4')
        check(bool(torch.equal(cpu[1], gpu[1])),
              f'smoke {name}: greedy tokens differ')
        results.append(dict(mode='bf16', path=name, max_abs_logit_err=err,
                            tol=1e-4))
    return results


def _to(tree, dev):
    from repro_torch.core.yoco_linear import QuantizedWeight
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(tree.wq.to(dev), tree.scale.to(dev))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ----------------------------------------------------------------------------
# phase 5: the main path at full width
# ----------------------------------------------------------------------------
TIER = dict(kv_quant=True, hot_window=2)
SERVE_RUNS = (
    # mode, prequantize, slots, requests, num_pages (None: full lanes),
    # stream, serve_continuous options. Streams: 'ragged' = the serve
    # path's synthetic 64-128-token prompts; 'full' = 128-token prompts;
    # 'shared' = 128-token prompts that open with one 96-token system
    # prompt (what chat users send on every request)
    ('bf16', False, 8, 16, None, 'ragged', {}),
    ('w8a8', True, 8, 16, None, 'ragged', {}),
    ('w8a8', False, 8, 8, None, 'ragged', {}),
    # full-length prompts: 3 lanes of 16 pages fill the 48-page pool and
    # all must grow past position 128, so the youngest is preempted (and
    # waits for a lane to finish instead of cycling through readmission)
    ('bf16', False, 4, 8, 1 + 48, 'full', {}),
    ('bf16', False, 8, 16, None, 'ragged', TIER),
    ('w8a8', True, 8, 16, None, 'ragged', TIER),
    # the private baseline of the two prefix-cache runs after it
    ('bf16', False, 8, 16, None, 'shared', {}),
    ('bf16', False, 8, 16, None, 'shared',
     dict(prefix_cache=True, chunk_prefill=32)),
    ('bf16', False, 8, 16, None, 'shared', dict(prefix_cache=True, **TIER)),
)
SHARED_PREFIX = 96


def _stream(SV, cfg, kind, n_req):
    """The request stream of a serve run (None: the serve path's own)."""
    if kind == 'ragged':
        return None
    from repro_torch.data import synthetic
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=n_req, seq_len=128), 0)['inputs'].numpy()
    if kind == 'full':
        return [SV.Request(rid=i, prompt=prompts[i], target_gen=32)
                for i in range(n_req)]
    prompts[:, :SHARED_PREFIX] = prompts[0, :SHARED_PREFIX]
    return [SV.Request(rid=i, prompt=prompts[i],
                       target_gen=16 + (i * 3) % 17) for i in range(n_req)]


def _prefill_chunks(out, stream, opts):
    """Chunked-prefill calls of a run, from its admit events: prefix hits
    (prefill_start > 0) always take chunks, misses only with chunk_prefill."""
    if out['chunk_prefill'] is None:
        return 0
    plen = {req.rid: len(req.prompt) for req in stream}
    c = out['chunk_prefill']
    return sum(-(-(plen[e['rid']] - e['prefill_start']) // c)
               for e in out['event_log'] if e['kind'] == 'admit'
               and (opts.get('chunk_prefill') or e['prefill_start'] > 0))


def serve_phase(torch, build):
    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    cfg = configs.get(ARCH, smoke=False)
    check(cfg.n_layers == LAYERS_FULL and cfg.d_model == 2048,
          'stablelm-1.6b FULL config changed')
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = M.init_params(gen, cfg, device='cuda')
    totals = {k: 0 for k in build.LAUNCHES}
    results = []
    private_peak = None
    for mode, prequant, slots, n_req, num_pages, kind, opts in SERVE_RUNS:
        # warm-up (library handles, allocator) outside the measured run
        SV.serve_continuous(ARCH, smoke=False, slots=slots, n_requests=1,
                            prompt_len=128, gen_len=2, mode=mode,
                            prequantize=prequant, params=params, quiet=True,
                            **opts)
        torch.cuda.synchronize()
        stream = _stream(SV, cfg, kind, n_req)
        build.reset_counts()
        out = SV.serve_continuous(ARCH, smoke=False, slots=slots,
                                  n_requests=n_req, prompt_len=128,
                                  gen_len=32, page_size=8,
                                  num_pages=num_pages, mode=mode,
                                  prequantize=prequant, attn_impl='flash',
                                  params=params, request_stream=stream,
                                  quiet=True, **opts)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        tag = (f'serve {mode} prequant={prequant} pages={num_pages} '
               f'stream={kind} {opts}')
        check(out['completed'] == n_req and out['failed'] == 0
              and out['rejected'] == 0 and out['cancelled'] == 0,
              f'{tag}: not every request finished: {out["events"]}')
        check(out['quarantined'] == 0,
              f'{tag}: {out["quarantined"]} lanes had non-finite logits')
        chunks = _prefill_chunks(out, stream, opts)
        forwards = out['steps'] + out['events']['admit']
        decode = LAYERS_FULL * out['steps']
        want = dict(flash_decode_paged=0 if out['kv_quant'] else decode,
                    flash_decode_paged_q8=decode if out['kv_quant'] else 0,
                    flash_chunk_paged=LAYERS_FULL * chunks,
                    quantize_rows=0, int8_matmul=0, yoco_vmm_int8=0)
        if mode == 'w8a8' and prequant:
            want.update(quantize_rows=LINEARS_PER_FORWARD * forwards,
                        int8_matmul=LINEARS_PER_FORWARD * forwards)
        elif mode == 'w8a8':
            want.update(quantize_rows=2 * LINEARS_PER_FORWARD * forwards,
                        yoco_vmm_int8=LINEARS_PER_FORWARD * forwards)
        for name, n in want.items():
            check(launches[name] == n,
                  f'{tag}: {name} launched {launches[name]} times, '
                  f'expected {n} ({out["steps"]} decode steps, {chunks} '
                  f'prefill chunks)')
        if num_pages is not None:
            check(out['preempted'] > 0, f'{tag}: the small pool forced no '
                                        f'preemption')
        if out['kv_quant']:
            check(out['pages_quantized'] > 0, f'{tag}: no page quantized')
        if kind == 'shared' and out['prefix'] is None:
            private_peak = out['peak_pages']
        if out['prefix'] is not None:
            check(chunks > 0, f'{tag}: no prefill chunk')
            check(out['prefix']['hits'] >= n_req - 1,
                  f'{tag}: {out["prefix"]["hits"]} prefix hits of {n_req}')
            check(out['peak_pages'] < private_peak,
                  f'{tag}: peak pages {out["peak_pages"]} not below the '
                  f'private run\'s {private_peak}')
        for k in totals:
            totals[k] += launches[k]
        decode_s = out['wall_s'] - out['prefill_s']
        results.append(dict(
            decode_step_ms=decode_s / max(out['steps'], 1) * 1e3,
            mode=mode, prequantize=prequant, slots=slots, requests=n_req,
            num_pages=out['total_pages'] + 1, prompt_len=128, gen_len=32,
            stream=kind, options=opts,
            tokens_per_s=out['tokens_per_s'], wall_s=out['wall_s'],
            prefill_s=out['prefill_s'], steps=out['steps'],
            decode_tokens=out['decode_tokens'], preempted=out['preempted'],
            peak_pages=out['peak_pages'],
            pages_quantized=out['pages_quantized'], prefix=out['prefix'],
            prefill_chunks=chunks, launches=launches))
        print(f'serve run: {json.dumps(results[-1])}', flush=True)
    return results, totals


# ----------------------------------------------------------------------------
# phase 4: device busy share of full-width serving
# ----------------------------------------------------------------------------
def profile_phase(torch):
    """Device busy share of full-width decode.
    A short bf16 and w8a8 --prequantize serve, timed once bare and once
    under ``torch.profiler``: the summed duration of every device kernel
    over the bare run's wall time, and the kernels that took most of it.
    Where the profiler records no device kernel, the share is reported as
    not measured (None)."""
    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    cfg = configs.get(ARCH, smoke=False)
    params = M.init_params(torch.Generator(device='cuda').manual_seed(0),
                           cfg, device='cuda')
    out = []
    for mode, prequant in (('bf16', False), ('w8a8', True)):
        kw = dict(smoke=False, slots=8, n_requests=8, prompt_len=128,
                  gen_len=8, mode=mode, prequantize=prequant, params=params,
                  quiet=True)
        SV.serve_continuous(ARCH, **kw)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SV.serve_continuous(ARCH, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = profiled_kernels(
            torch, lambda: SV.serve_continuous(ARCH, **kw))
        busy_ms = sum(v[0] for v in by_name.values()) if by_name else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        out.append(dict(mode=mode, prequantize=prequant, wall_ms=wall_ms,
                        device_busy_ms=busy_ms,
                        device_busy_share=(None if busy_ms is None
                                           else busy_ms / wall_ms),
                        kernel_launches=sum(v[1] for v in by_name.values()),
                        top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                             for k, v in top]))
        print(f'profile: {json.dumps(out[-1])}', flush=True)
    return out


def run_phases(torch, report, kmods):
    """The check phases after the build; fills ``report`` as they pass and
    returns the main path's launch totals."""
    report['kernel_sweep'] = kernel_phase(torch, kmods)
    print(f'kernel checks passed: {len(report["kernel_sweep"])} shapes',
          flush=True)
    report['kernel_sweep'] += tier_chunk_kernel_phase(torch, kmods)
    print('K5/K6 checks passed', flush=True)
    report['smoke'] = smoke_phase(torch) + smoke_tier_prefix_phase(torch)
    print(f'smoke parity: {json.dumps(report["smoke"])}', flush=True)
    report['profile'] = profile_phase(torch)
    report['serve'], totals = serve_phase(torch, kmods[3])
    for k, n in totals.items():
        check(n > 0, f'kernel {k} was never launched on the main path')
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, 'repro_torch')):
        print(f'chip_smoke: {SRC}/repro_torch not found: run from a '
              f'checkout of the repository', file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels import yoco_vmm as ky

    smi = smi_line()
    print(smi, flush=True)
    report = dict(smi=smi, device=torch.cuda.get_device_name(0))
    t0 = time.time()
    build.build()
    report['build_s'] = time.time() - t0
    report['build_logs'] = dict(build.BUILD_LOGS)
    print(f'built kernels in {report["build_s"]:.1f} s', flush=True)
    for name, log in build.BUILD_LOGS.items():
        print(f'--- nvcc {name}.cu\n{log.strip()}', flush=True)
    try:
        totals = run_phases(torch, report, (fd, kq, ky, build))
    finally:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
            json.dump(report, f, indent=1)
    rows = report['kernel_sweep']
    # one line per kernel, at its serving-path decode shape; K5 at the
    # page-size chunk of a prefix hit, which carries most of its launches
    pick = {'flash_decode_paged': dict(pool='bfloat16'),
            'flash_chunk_paged': dict(pool='bfloat16', C=8, offset=96),
            'flash_decode_paged_q8': dict(pool='bfloat16'),
            'quantize_rows': dict(M=8, K=2048, dtype='bfloat16'),
            'int8_matmul': dict(M=8, K=2048, N=100352),
            'yoco_vmm_int8': dict(M=8, K=2048, N=100352)}
    kernels = []
    for name, want in pick.items():
        for r in rows:
            if r['name'] == name and all(r['shape'].get(k) == v
                                         for k, v in want.items()):
                kernels.append(dict(
                    name=name, route=r['route'], source=r['source'],
                    replaces=r['replaces'],
                    launches=totals[name],
                    max_abs_err=r['max_abs_err'], ms=r['ms'],
                    plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'],
                    timer=r['timer'], shape=r['shape']))
                break
    check(sorted(k['name'] for k in kernels) == sorted(pick),
          'a kernel is missing from the kernels line')
    print(json.dumps(dict(kernels=kernels)), flush=True)
    print(json.dumps(dict(serve=report['serve'])), flush=True)
    print(smi, flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform='gpu', kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f'chip_smoke: FAIL: {e}', file=sys.stderr)
        sys.exit(1)
