#!/usr/bin/env python3
"""Dump the outputs of the attention kernels (K1, K5-K10) and K3 on seeded
finite inputs at the serving shapes, or compare two dumps bit for bit.

A kernel edit that must leave finite outputs unchanged (a NaN repair, say)
is checked by dumping once per tree in one call on the card, each with that
tree's ``src`` first on the path (its kernels build from its own
``csrc``), then comparing:

  PYTHONPATH=<parent>/src python3 tools/kernel_outputs.py --dump a.pt
  PYTHONPATH=src python3 tools/kernel_outputs.py --dump b.pt
  python3 tools/kernel_outputs.py --compare a.pt b.pt

Shapes (bf16 and f32 pools each): K1 and K6 (hot window 2) at B=8,
Hkv=32, dh=64, page size 8, W=20 with a 9-key window on odd slots and
at W=512; K5 at C=8 and 32, offset 96; K7 at B=8, S=160; K8 and K10
(hot window 2) at H=128, DK=576, r=512, W=20 and W=512; K9 at C=8 and 32,
offset 96; K3 on bf16 activations (M=8: K=2048, 7168; M=1024, K=2048) and
an f32 weight transpose (M=5632, K=2048). ``--compare`` prints one line a
tensor and exits non-zero unless every tensor is bit-equal.
"""

from __future__ import annotations

import sys


def dump(path: str) -> None:
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quantize as kq
    from repro_torch.runtime import kv_quant as kvq

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def table(b, w):
        return (torch.randperm(b * w, generator=gen, device=dev) + 1) \
            .reshape(b, w).to(torch.int32).contiguous()

    ps, hw = 8, 2
    hwt = torch.tensor([hw], dtype=torch.int32, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).replace('torch.', '')
        # K1, K6 and K7: GQA, B=8, Hkv=32, G=1, dh=64
        b, hkv, dh = 8, 32, 64
        scale = 1.0 / dh ** 0.5
        for w in (20, 512):
            bt = table(b, w)
            pos = torch.randint(1, w * ps, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
            win = torch.full((b,), w * ps + 1, dtype=torch.int32,
                             device=dev)
            if w == 20:
                pos[0], bt[0] = 0, 0
                win[1::2] = 9
            q = rnd(b, hkv, 1, dh)
            n = 1 + b * w
            c = dict(k=rnd(n, ps, hkv, dh, dt=dt),
                     v=rnd(n, ps, hkv, dh, dt=dt),
                     kq=torch.zeros((n, ps, hkv, dh), dtype=torch.int8,
                                    device=dev),
                     vq=torch.zeros((n, ps, hkv, dh), dtype=torch.int8,
                                    device=dev),
                     ks=torch.zeros((n, hkv), device=dev),
                     vs=torch.zeros((n, hkv), device=dev))
            cold = kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, hw)
            kvq.quantize_pages_layer(c, torch.tensor(cold, device=dev))
            out[f'K1 W={w} {tag}'] = fd.flash_decode_gqa_paged(
                q, c['k'], c['v'], pos, win, bt, scale=scale)
            out[f'K6 W={w} {tag}'] = fd.flash_decode_gqa_paged_q8(
                q, c['k'], c['v'], c['kq'], c['vq'], c['ks'], c['vs'], pos,
                win, bt, hwt, scale=scale)
            if w == 20:
                for cc in (8, 32):
                    qc = rnd(1, hkv, cc, dh)
                    offv, posv, winv = fd._chunk_scalars(96, 128, None, 1, cc,
                                                         w * ps, dev)
                    out[f'K5 C={cc} {tag}'] = fd.flash_decode_gqa_paged(
                        qc, c['k'], c['v'], posv, winv, bt[:1].contiguous(),
                        offv, scale=scale, chunk=cc)
            del c
        kc, vc = rnd(b, 160, hkv, dh, dt=dt), rnd(b, 160, hkv, dh, dt=dt)
        pos = torch.randint(100, 160, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        win = torch.full((b,), 161, dtype=torch.int32, device=dev)
        win[1::2] = 33
        out[f'K7 S=160 {tag}'] = fd.flash_decode_gqa(
            rnd(b, hkv, 1, dh), kc, vc, pos, win, scale=scale)
        # K8, K9 and K10: H=128, DK=576, r=512
        h, r, dk = 128, 512, 576
        scale = 1.0 / (128 + 64) ** 0.5
        for w in (20, 512):
            bt = table(b, w)
            pos = torch.randint(96 if w == 20 else w * ps - 16, w * ps, (b,),
                                generator=gen, device=dev, dtype=torch.int32)
            if w == 20:
                pos[0], bt[0] = 0, 0
            win = torch.full((b,), w * ps + 1, dtype=torch.int32,
                             device=dev)
            n = 1 + b * w
            cl = rnd(n, ps, dk, dt=dt)
            c = dict(cl=cl, clq=torch.zeros((n, ps, dk), dtype=torch.int8,
                                            device=dev),
                     cs=torch.zeros((n, 1), device=dev))
            cold = kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, hw)
            kvq.quantize_latent_pages_layer(c, torch.tensor(cold,
                                                            device=dev))
            q = rnd(b, 1, h, dk)
            out[f'K8 W={w} {tag}'] = fd.flash_decode_mla_paged(
                q, cl, pos, win, bt, scale=scale, r=r)
            out[f'K10 W={w} {tag}'] = fd.flash_decode_mla_paged_q8(
                q, cl, c['clq'], c['cs'], pos, win, bt, hwt, scale=scale,
                r=r)
            if w == 20:
                for cc in (8, 32):
                    qc = rnd(1, 1, cc * h, dk)
                    offv, posv, winv = fd._chunk_scalars(96, 128, None, 1, cc,
                                                         w * ps, dev)
                    out[f'K9 C={cc} {tag}'] = fd.flash_decode_mla_paged(
                        qc, cl, posv, winv, bt[:1].contiguous(), offv,
                        scale=scale, r=r, chunk=cc)
            del c, cl
    for m, k, dt in ((8, 2048, torch.bfloat16), (8, 7168, torch.bfloat16),
                     (1024, 2048, torch.bfloat16),
                     (5632, 2048, torch.float32)):
        xq, sx = kq.quantize_rows(rnd(m, k, dt=dt))
        out[f'K3 codes ({m},{k}) {dt}'] = xq
        out[f'K3 scales ({m},{k}) {dt}'] = sx
    torch.cuda.synchronize()
    torch.save({key: v.cpu() for key, v in out.items()}, path)
    print(f'{len(out)} outputs to {path}', flush=True)


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    bad = 0
    for key in sorted(set(x) | set(y)):
        if key not in x or key not in y:
            print(f'{key}: only in {a if key in x else b}')
            bad += 1
            continue
        same = x[key].dtype == y[key].dtype and x[key].shape == y[key].shape
        if same:
            bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
                x[key].element_size()]
            same = bool(torch.equal(x[key].view(bits), y[key].view(bits)))
        finite = bool(torch.isfinite(x[key].float()).all())
        print(f'{key}: {"bit-equal" if same else "DIFFERENT"}'
              f'{"" if finite else " (non-finite values)"}')
        bad += not same
    print(f'{len(set(x) | set(y)) - bad} of {len(set(x) | set(y))} '
          f'bit-equal')
    return 1 if bad else 0


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--dump':
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == '--compare':
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
