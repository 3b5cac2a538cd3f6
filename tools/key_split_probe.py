#!/usr/bin/env python3
"""Where K5's key split (``key_split_kernel`` with chunk rows) spends its
cycles at a 4,096-token context, on one NVIDIA H100.

Builds a copy of ``src/repro_torch/csrc/flash_decode.cu`` whose
``key_split_kernel`` reads ``clock64()`` at the boundaries of its phases
(the prologue up to the key loop: page staging, the first step's loads,
the query rows; each step's wait for its key and value rows, forced by a
use of every loaded word; the QK dot products; the online softmax; PV;
the epilogue that merges lane groups and warps and writes the partial),
sums them per warp over the block's steps, and runs K5 on
``chip_smoke.py``'s shapes (one request, Hkv=32, G=1, dh=64, page size
8): C=2, 8 and 32 at the end of a 512-page table (a 4,096-token context,
1, 4 and 16 row groups of 2 rows a KV head, each group reading every key
row) and C=8 at offset 96 of a 20-page one, bf16 and f32 pools. Each
shape prints the phases' shares of a warp's cycles and, from the built
(uninstrumented) kernel, the call's and the key split's device times
(``chip_smoke.device_ms``, ``profiled_kernels``), warm and with the L2
flushed first (``cold_device_ms``). The instrumented kernel is slower
than the built one; the shares, not the cycles, are the reading.

Usage (from the repository root, on the card's machine):
    python3 tools/key_split_probe.py
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

PHASES = ('prologue', 'wait', 'qk', 'softmax', 'pv', 'epilogue')
# (anchor in the kernel, code inserted after it)
PROBES = (
    ('  Rows kv = loader;   // stage() fills in the split\'s staged pages\n',
     '  const long long probe_start = clock64();\n'
     '  unsigned long long probe_t[6] = {0, 0, 0, 0, 0, 0};\n'
     '  unsigned probe_sink = 0;\n'),
    ('    dequant_step<Rows>(kr, vr, cold, kc, vc, dh - d0, pstride);\n',
     '#pragma unroll\n'
     '    for (int u = 0; u < kStepKeys; ++u)\n'
     '#pragma unroll\n'
     '      for (int c = 0; c < kPieces; ++c)\n'
     '        probe_sink ^= kr[u][c].x ^ kr[u][c].y ^ kr[u][c].z ^\n'
     '                      kr[u][c].w ^ vr[u][c].x ^ vr[u][c].y ^\n'
     '                      vr[u][c].z ^ vr[u][c].w;\n'
     '    const long long probe_c1 = clock64();\n'
     '    probe_t[1] += probe_c1 - probe_c0;\n'),
    ('            acc[r][c * V + e] += logit[r][u] * vf[c][e];\n'
     '    }\n',
     '    probe_t[4] += clock64() - probe_c3;\n'),
)
# (anchor in the kernel, code inserted before it)
BEFORE = (
    ('  for (int kb = k_first; kb < k_last; kb += span) {\n',
     '  probe_t[0] = clock64() - probe_start;\n'),
    ('    if (kb != k_first)\n',
     '    const long long probe_c0 = clock64();\n'),
    ('    // the online update: logit[r][u] becomes p, acc is rescaled, then '
     'the\n',
     '    const long long probe_c2 = clock64();\n'
     '    probe_t[2] += probe_c2 - probe_c1;\n'),
    ('#pragma unroll\n    for (int u = 0; u < kStepKeys; ++u) {\n'
     '      float vf[kPieces][V];\n',
     '    const long long probe_c3 = clock64();\n'
     '    probe_t[3] += probe_c3 - probe_c2;\n'),
    ('  // merge the lane groups of each warp',
     '  const long long probe_c5 = clock64();\n'),
)
TAIL = ('  probe_t[5] = clock64() - probe_c5;\n'
        '  if (lane == 0) {\n'
        '    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y'
        ' * blockIdx.z);\n'
        '    for (int i = 0; i < 6; ++i)\n'
        '      g_probe[(blk * kSplitWarps + warp) * 6 + i] = probe_t[i];\n'
        '  }\n'
        '  if (probe_sink == 0x9e3779b9u) g_probe_sink = probe_sink;\n')
PROBE_WORDS = 1 << 17
# (W, limit, C, offset)
SHAPES = ((512, 4096, 2, 4094), (512, 4096, 8, 4088), (512, 4096, 32, 4064),
          (20, 128, 8, 96))


def instrumented_source() -> str:
    src = open(os.path.join(ROOT, 'src/repro_torch/csrc/flash_decode.cu')) \
        .read()
    src = src.replace('#include "common.cuh"', '#include "' + os.path.join(
        ROOT, 'src/repro_torch/csrc/common.cuh') + '"')
    head = ('template <typename Rows, int kRows, bool kAligned, bool kChunk, '
            'int kPieces>\n'
            '__global__ void __launch_bounds__(kSplitThreads)\n'
            'key_split_kernel(')
    start = src.index(head)
    end = src.index('\n}\n', start)
    body = src[start:end]
    for anchor, code in PROBES:
        assert body.count(anchor) == 1, anchor
        body = body.replace(anchor, anchor + code)
    for anchor, code in BEFORE:
        assert body.count(anchor) == 1, anchor
        body = body.replace(anchor, code + anchor)
    return (src[:start]
            + f'__device__ unsigned long long g_probe[{PROBE_WORDS}];\n'
            + '__device__ unsigned g_probe_sink;\n'
            + body + '\n' + TAIL + src[end:]
            + '\nREPRO_EXPORT int probe_read(void* host, int n) {\n'
            '  return static_cast<int>(cudaMemcpyFromSymbol(host, g_probe, '
            'n * sizeof(unsigned long long)));\n}\n'
            'REPRO_EXPORT int probe_clear() {\n  void* p = nullptr;\n'
            '  cudaError_t e = cudaGetSymbolAddress(&p, g_probe);\n'
            '  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_probe));\n'
            '  return static_cast<int>(e);\n}\n')


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd

    if not torch.cuda.is_available():
        print('key_split_probe: no CUDA device visible', file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    out_dir = os.path.join(ROOT, 'build', 'probe')
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, f) for f in ('key_probe.cu',
                                                  'libkey_probe.so'))
    with open(cu, 'w') as f:
        f.write(instrumented_source())
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, '-o', so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    build.build(['flash_decode'])
    log = proc.communicate()[0]
    if proc.returncode:
        print(log, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    probe_fn = lib.flash_chunk_paged
    probe_fn.restype, probe_fn.argtypes = ctypes.c_int, fd._K5_ARGS
    key = ('flash_decode', 'flash_chunk_paged')
    built_fn = build.function(*key, fd._K5_ARGS)

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    b, hkv, g, dh, ps = 1, 32, 1, 64, 8
    scale = 1.0 / dh ** 0.5
    ok = True
    for w, limit, c, off in SHAPES:
        n_pages = 1 + w
        bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
            .reshape(b, w).to(torch.int32).contiguous()
        for dt in (torch.bfloat16, torch.float32):
            kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                             device=dev).to(dt)
            vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                             device=dev).to(dt)
            qg = torch.randn((b, hkv, c * g, dh), generator=gen, device=dev)
            offv, posv, winv = fd._chunk_scalars(off, limit, None, b, c,
                                                 w * ps, dev)
            args = (qg, kp, vp, posv, winv, bt, offv)

            def k5(args=args, c=c):
                return fd.flash_decode_gqa_paged(*args, scale=scale, chunk=c)
            want = fd.flash_decode_gqa_paged_plain(*args, scale=scale,
                                                   chunk=c)
            n_valid = min(c, limit - off)
            err = float((k5() - want)[:, :, :n_valid * g].abs().max())
            ok &= err <= 1e-5
            ms, timer, _ = cs.device_ms(torch, k5, expect=2)
            per = cs.profiled_kernels(
                torch, lambda k5=k5: [k5() for _ in range(20)])
            split_ms = sum(v[0] for n, v in per.items()
                           if 'key_split_kernel' in n) / 20
            cold_ms = cs.cold_device_ms(torch, k5)
            plan = fd.chunk_split_plan(b, w, ps, hkv, c, g, dh,
                                       kp.element_size())
            blocks = b * hkv * plan['n_splits'] * -(-c * g // plan['rows'])
            n = blocks * 4 * 6
            assert n <= PROBE_WORDS
            build._FNS[key] = probe_fn
            try:
                assert lib.probe_clear() == 0
                for _ in range(3):
                    got = k5()
                torch.cuda.synchronize()
                ok &= float((got - want)[:, :, :n_valid * g].abs().max()) \
                    <= 1e-5
                buf = (ctypes.c_ulonglong * n)()
                assert lib.probe_read(buf, n) == 0
                ims, itimer, _ = cs.device_ms(torch, k5, expect=2)
            finally:
                build._FNS[key] = built_fn
            cyc = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, 4, 6) \
                .astype(float)
            live = cyc.sum(-1) > 0                   # dead splits write none
            total = cyc.sum(-1)[live].mean()
            keys = off + n_valid
            print(json.dumps(dict(
                kernel='K5', shape=dict(B=b, Hkv=hkv, G=g, dh=dh,
                                        page_size=ps, W=w, C=c, offset=off,
                                        pool=str(dt).replace('torch.', ''),
                                        plan=plan),
                row_groups=-(-c * g // plan['rows']), blocks=blocks,
                live_warps=int(live.sum()), keys=keys,
                kv_bytes=2 * keys * hkv * dh * kp.element_size(),
                max_abs_err=err, ms=ms, timer=timer, split_ms=split_ms,
                cold_ms=cold_ms, cycles_a_warp=total,
                share={p: cyc[..., i][live].mean() / total
                       for i, p in enumerate(PHASES)},
                instrumented_ms=ims, instrumented_timer=itimer)),
                flush=True)
            del kp, vp
    print(cs.smi_line(), flush=True)
    print(json.dumps(dict(ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
