#!/usr/bin/env python3
"""The cuts of kernel K3 that its plan did not take, timed beside the
ones it takes, on one NVIDIA H100.

K3 (``kernels/quantize.py::quantize_plan``): decode rows (M=8, 128) on
one CTA a row against a thread-block cluster of 128-piece CTAs, and
several-rows cuts (prefill activations, dynamic w8a8's f32 weight rows)
at 1, 2, 4 and 8 16-byte pieces a thread, by patching the plan's
constants (each cut bit-exact against the plain version first). Times
are ``chip_smoke.device_ms`` (profiler device time a call, 20 calls), two
rounds in turns; one JSON line a reading.

Usage (from the repository root, on the card's machine):
    python3 tools/cut_variants.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))
sys.path.insert(0, ROOT)

K3_ROWS = ((8, 2048, 'bfloat16'), (8, 7168, 'bfloat16'),
           (8, 18432, 'bfloat16'), (128, 2048, 'bfloat16'),
           (1024, 2048, 'bfloat16'), (1024, 5632, 'bfloat16'),
           (100352, 2048, 'float32'), (129280, 7168, 'float32'))
# (name, plan constants): the plan's own cut first
K3_CUTS = (('plan', {}),
           ('decode_one_cta', dict(QUANT_CTA_PIECES=1 << 30)),
           ('decode_cluster', dict(QUANT_CTA_PIECES=0)),
           ('rows_vecs1', dict(QUANT_ROW_VECS=1, QUANT_STREAM_VECS=1)),
           ('rows_vecs2', dict(QUANT_ROW_VECS=2, QUANT_STREAM_VECS=2)),
           ('rows_vecs4', dict(QUANT_ROW_VECS=4, QUANT_STREAM_VECS=4)),
           ('rows_vecs8', dict(QUANT_ROW_VECS=8, QUANT_STREAM_VECS=8)))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as kq

    if not torch.cuda.is_available():
        print('cut_variants: no CUDA device visible', file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    build.build(['quantize'])
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True

    base = {k: getattr(kq, k) for cut in K3_CUTS for k in cut[1]}
    xs = {}
    for m, k, dt in K3_ROWS:
        x = torch.randn((m, k), generator=gen, device=dev).to(
            getattr(torch, dt))
        x[0] = 0
        xs[m, k] = x
    for turn in range(2):
        for name, consts in K3_CUTS:
            for key, val in {**base, **consts}.items():
                setattr(kq, key, val)
            for m, k, dt in K3_ROWS:
                x = xs[m, k]
                plan = kq.quantize_plan(m, k, x.element_size())
                q, s = kq.quantize_rows(x)
                qp, sp = kq.quantize_rows_plain(x)
                exact = bool(torch.equal(q, qp) and torch.equal(s, sp))
                ok &= exact
                del q, s, qp, sp
                ms, timer, _ = cs.device_ms(
                    torch, lambda x=x: kq.quantize_rows(x), expect=1)
                print(json.dumps(dict(kernel='K3', cut=name, turn=turn, M=m,
                                      K=k, dtype=dt, ms=ms, timer=timer,
                                      bit_exact=exact, plan=plan)),
                      flush=True)
    for key, val in base.items():
        setattr(kq, key, val)
    print(cs.smi_line(), flush=True)
    print(json.dumps(dict(ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
