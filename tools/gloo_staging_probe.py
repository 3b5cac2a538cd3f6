"""The device bytes a gloo collective allocates on a CUDA tensor beyond
its own output: ranks that share one card go over gloo, which copies
through host memory, and some of its collectives stage a device copy of
their operand first. The dry run's live-byte model (``launch/dryrun.py``)
counts no such copy (NCCL stages none through the caching allocator), so
a card's peak over gloo can exceed it by the largest copy in flight at
the peak.

Two ranks on ``cuda:0`` over gloo run each collective that
``distributed/collectives.py`` makes (``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``all_reduce``, ``all_to_all_single``) on an
f32 operand of each size, its output allocated before; each reads
``torch.cuda.max_memory_allocated`` less what was allocated before the
call. Prints one JSON line: per kind and size the staged bytes and their
ratio to the input's and the output's bytes.

Usage (needs a card): python tools/gloo_staging_probe.py [MiB ...]
"""

import json
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank(rank, port, sizes, out_path):
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            rank=rank, world_size=RANKS)
    dev = torch.device('cuda:0')
    rows = []
    for mib in sizes:
        n = (mib << 20) // 4
        for kind in ('reduce_scatter', 'all_gather', 'all_reduce',
                     'all_to_all'):
            if kind == 'reduce_scatter':
                x = torch.ones(n, device=dev)
                out = torch.empty(n // RANKS, device=dev)
                call = lambda: dist.reduce_scatter_tensor(out, x)  # noqa
            elif kind == 'all_gather':
                x = torch.ones(n // RANKS, device=dev)
                out = torch.empty(n, device=dev)
                call = lambda: dist.all_gather_into_tensor(out, x)  # noqa
            elif kind == 'all_reduce':
                x = out = torch.ones(n, device=dev)
                call = lambda: dist.all_reduce(x)  # noqa
            else:
                x = torch.ones(n, device=dev)
                out = torch.empty(n, device=dev)
                call = lambda: dist.all_to_all_single(out, x)  # noqa
            torch.cuda.synchronize(dev)
            dist.barrier()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            call()
            torch.cuda.synchronize(dev)
            staged = torch.cuda.max_memory_allocated(dev) - before
            rows.append(dict(kind=kind, MiB=mib,
                             input_bytes=x.numel() * 4,
                             output_bytes=out.numel() * 4,
                             staged_bytes=staged,
                             staged_per_input=staged / (x.numel() * 4),
                             staged_per_output=staged / (out.numel() * 4)))
            del x, out
            torch.cuda.empty_cache()
    if rank == 0:
        with open(out_path, 'w') as f:
            json.dump(rows, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('gloo_staging_probe: no CUDA device visible', file=sys.stderr)
        return 1
    sizes = [int(a) for a in argv] or [64, 256]
    out_path = os.path.join(os.environ.get('TMPDIR', '/tmp'),
                            f'gloo_staging_{os.getpid()}.json')
    mp.spawn(_rank, args=(_free_port(), sizes, out_path), nprocs=RANKS)
    with open(out_path) as f:
        rows = json.load(f)
    os.remove(out_path)
    print(json.dumps(dict(gloo_staging=rows,
                          torch=torch.__version__)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
