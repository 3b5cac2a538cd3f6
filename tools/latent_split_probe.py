#!/usr/bin/env python3
"""Where a latent-split block (kernels K8 and K10) spends its cycles, on
one NVIDIA H100.

Builds a copy of ``src/repro_torch/csrc/flash_decode.cu`` whose
``latent_split_kernel`` reads ``clock64()`` at the boundaries of each
step's phases (waiting for the step's rows and issuing the next step's
copies; the prepare pass that zeroes masked rows and dequantizes cold
ones; QK^T; the barrier after it; the online softmax; PV), sums them per
warp over the block's steps, and runs K8 and K10 (hot window 2) at
deepseek-v3's width and a 4,096-token context (B=8, H=128, DK=576,
r=512, page size 8, W=512, bf16 pool; ``chip_smoke.py``'s W=512 row),
printing each phase's share of a warp's cycles and the call's device time
(``chip_smoke.device_ms``). The instrumented kernel is slower than the
built one; the shares, not the cycles, are the reading.

Usage (from the repository root, on the card's machine):
    python3 tools/latent_split_probe.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))
sys.path.insert(0, ROOT)

PHASES = ('wait_and_issue', 'prepare', 'qk', 'barrier_after_qk', 'softmax',
          'pv')
# (anchor in the kernel, code inserted after it)
PROBES = (
    ('  uint32_t phase = 0;\n',
     '  unsigned long long probe_t[6] = {0, 0, 0, 0, 0, 0};\n'),
    ('  for (int kb = k_first; kb < k_end; kb += kLatStep) {\n',
     '    long long probe_c0 = clock64();\n'),
    ('    KV* tb = s_tile + stage * kLatStep * ls;\n',
     '    long long probe_c1 = clock64(); probe_t[0] += probe_c1 - probe_c0;\n'),
    ('    // QK^T: this warp\'s m-tile against the step\'s keys over its '
     'quarter\n',
     '    long long probe_c2 = clock64(); probe_t[1] += probe_c2 - probe_c1;\n'),
    ('    // the step\'s online softmax: row tid / 8, keys 4 (tid % 8) .. + 3\n',
     '    long long probe_c4 = clock64(); probe_t[3] += probe_c4 - probe_c3;\n'),
    ('    // PV: rescale, then add the step\'s values into this warp\'s '
     'columns,\n',
     '    long long probe_c5 = clock64(); probe_t[4] += probe_c5 - probe_c4;\n'),
    ('    stage = stage + 1 == kStages ? 0 : stage + 1;\n',
     '    probe_t[5] += clock64() - probe_c5;\n'),
    ('  // the split\'s partial: m, l and the unnormalised accumulator\n',
     '  if (lane == 0) {\n'
     '    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *'
     ' blockIdx.z);\n'
     '    for (int i = 0; i < 6; ++i)\n'
     '      g_probe[(blk * kLatWarps + warp) * 6 + i] = probe_t[i];\n'
     '  }\n'),
)
# the QK^T phase ends before the barrier that follows its stores
QK_END = ('            make_float2(sacc[j][2], sacc[j][3]);\n      }\n    }\n'
          '    __syncthreads();\n')


def instrumented_source() -> str:
    src = open(os.path.join(ROOT, 'src/repro_torch/csrc/flash_decode.cu')) \
        .read()
    src = src.replace('#include "common.cuh"', '#include "' + os.path.join(
        ROOT, 'src/repro_torch/csrc/common.cuh') + '"')
    head = 'template <typename KV, bool kChunk>\n__global__ void ' \
        '__launch_bounds__(kLatThreads, 1)\nlatent_split_kernel('
    start = src.index(head)
    end = src.index('\n}\n', start)
    body = src[start:end]
    for anchor, code in PROBES:
        assert body.count(anchor) == 1, anchor
        body = body.replace(anchor, anchor + code)
    assert body.count(QK_END) == 1
    body = body.replace(QK_END, QK_END.replace(
        '    __syncthreads();\n',
        '    long long probe_c3 = clock64(); probe_t[2] += probe_c3 - probe_c2;\n'
        '    __syncthreads();\n'))
    return (src[:start] + '__device__ unsigned long long g_probe[1 << 16];\n'
            + body + src[end:] + '\nREPRO_EXPORT int probe_read(void* host, '
            'int n) {\n  return static_cast<int>(cudaMemcpyFromSymbol(host, '
            'g_probe, n * sizeof(unsigned long long)));\n}\n')


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.runtime import kv_quant as kvq

    if not torch.cuda.is_available():
        print('latent_split_probe: no CUDA device visible', file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, 'build', 'probe')
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, f) for f in ('probe.cu', 'libprobe.so'))
    with open(cu, 'w') as f:
        f.write(instrumented_source())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-o', so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for name, args in (('flash_decode_paged_mla', fd._K8_ARGS),
                       ('flash_decode_paged_mla_q8', fd._K10_ARGS)):
        fns[name] = getattr(lib, name)
        fns[name].restype, fns[name].argtypes = ctypes.c_int, args

    dev = 'cuda'
    gen = torch.Generator(device=dev).manual_seed(6)
    b, h, dk, r, ps, w, hw = 8, 128, 576, 512, 8, 512, 2
    bt = (torch.randperm(b * w, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = w * ps - 1 - torch.randint(0, 16, (b,), generator=gen, device=dev,
                                     dtype=torch.int32)
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, dk), generator=gen, device=dev)
    cl = torch.randn((1 + b * w, ps, dk), generator=gen, device=dev) \
        .to(torch.bfloat16)
    tier = dict(cl=cl, clq=torch.zeros(cl.shape, dtype=torch.int8,
                                       device=dev),
                cs=torch.zeros((cl.shape[0], 1), device=dev))
    cold = kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, hw)
    kvq.quantize_latent_pages_layer(tier, torch.tensor(cold, device=dev))
    hwt = torch.tensor([hw], dtype=torch.int32, device=dev)
    plan = fd.latent_split_plan(b, w, ps, h, dk, r, 2)
    part, out = fd._split_scratch(b, 1, h, r, plan, q.device)
    tail = (*(t.data_ptr() for t in part), out.data_ptr(), b, h, dk, r, ps,
            w, *fd._latent_plan_args(plan), 1.0 / 192 ** 0.5, 1,
            build.stream_of(q))
    calls = dict(
        K8=lambda: fns['flash_decode_paged_mla'](
            q.data_ptr(), cl.data_ptr(), pos.data_ptr(), win.data_ptr(),
            bt.data_ptr(), *tail),
        K10=lambda: fns['flash_decode_paged_mla_q8'](
            q.data_ptr(), cl.data_ptr(), tier['clq'].data_ptr(),
            tier['cs'].data_ptr(), hwt.data_ptr(), pos.data_ptr(),
            win.data_ptr(), bt.data_ptr(), *tail))
    blocks = b * (h // fd.LATENT_ROWS) * plan['n_splits']
    n = blocks * 8 * 6
    for name, call in calls.items():
        for _ in range(3):
            assert call() == 0
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * n)()
        assert lib.probe_read(buf, n) == 0
        cyc = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, 8, 6) \
            .astype(float)
        total = cyc.sum(-1).mean()
        ms, timer, _ = cs.device_ms(torch, call, expect=2)
        print(json.dumps(dict(
            kernel=name, shape=dict(B=b, H=h, DK=dk, r=r, page_size=ps, W=w,
                                    pool='bfloat16', plan=plan,
                                    hot_window=hw if name == 'K10' else None),
            cycles_a_warp=total,
            share={p: cyc[:, :, i].mean() / total
                   for i, p in enumerate(PHASES)},
            instrumented_ms=ms, timer=timer)), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
