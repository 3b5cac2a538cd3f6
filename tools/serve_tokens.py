#!/usr/bin/env python3
"""Dump the greedy tokens of seeded full-width serves on the card, or
compare two dumps.

A change to how weights are made or to the model loop that must leave
served tokens unchanged is checked by dumping once per tree in one call on
the card, each with that tree's ``src`` first on the path, then comparing:

  PYTHONPATH=<parent>/src python3 tools/serve_tokens.py --dump a.json
  PYTHONPATH=src python3 tools/serve_tokens.py --dump b.json
  python3 tools/serve_tokens.py --compare a.json b.json

Serves (``serve_continuous``, seed 0, page 8, 8 slots, the synthetic
ragged stream of 8 requests with prompts up to 128 tokens, generation up
to 16): stablelm-1.6b in bf16, w8a8 --prequantize and dynamic w8a8, and
deepseek-v3's first 3 layers (MLA, the MoE layers dropped) in bf16 and
dynamic w8a8. Beside them, SHA-256 digests of ``prequantize_weight``'s
codes and scales for seeded f32 weights of stablelm-1.6b's and
qwen2-vl-72b's lm_head shapes, quantized on the card. ``--compare`` prints
one line a serve or weight and exits non-zero unless every request's
tokens and every digest are equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys

RUNS = (('stablelm-1.6b', 'bf16', False), ('stablelm-1.6b', 'w8a8', True),
        ('stablelm-1.6b', 'w8a8', False), ('deepseek-v3-dense3', 'bf16', False),
        ('deepseek-v3-dense3', 'w8a8', False))
PREQUANT_SHAPES = ((2048, 100352), (8192, 152064))


def dump(path: str) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.core.yoco_linear import prequantize_weight
    from repro_torch.launch import serve as SV

    full = configs.get('deepseek-v3-671b')
    configs.base.register(
        dataclasses.replace(full, name='deepseek-v3-dense3', n_layers=3,
                            moe=None),
        dataclasses.replace(configs.get('deepseek-v3-671b', smoke=True),
                            name='deepseek-v3-dense3', moe=None))
    out = {}
    for arch, mode, prequant in RUNS:
        res = SV.serve_continuous(arch, smoke=False, slots=8, n_requests=8,
                                  prompt_len=128, gen_len=16, mode=mode,
                                  prequantize=prequant, seed=0, quiet=True,
                                  metrics=False)
        torch.cuda.synchronize()
        out[f'{arch} {mode} prequantize={prequant}'] = {
            str(rid): toks for rid, toks in res['outputs'].items()}
    for k, n in PREQUANT_SHAPES:
        gen = torch.Generator(device='cuda').manual_seed(0)
        q = prequantize_weight(torch.randn((k, n), generator=gen,
                                           device='cuda'))
        out[f'prequantize_weight ({k}, {n})'] = {
            name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for name, t in (('codes', q.wq.t()), ('scale', q.scale))}
        del q
    with open(path, 'w') as f:
        json.dump(out, f)


def compare(a: str, b: str) -> int:
    with open(a) as f:
        x = json.load(f)
    with open(b) as f:
        y = json.load(f)
    bad = 0
    for key in sorted(set(x) | set(y)):
        same = x.get(key) == y.get(key)
        n = len(x.get(key) or {})
        print(f'{key}: {"equal" if same else "DIFFERENT"} ({n} entries)')
        bad += not same
    return 1 if bad else 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == '--dump':
        dump(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == '--compare':
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
