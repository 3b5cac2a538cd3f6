"""The production-mesh dry run (port of ``repro/launch/dryrun.py``): one
rank's real step of every (architecture x input shape) cell on the meta
device, with what it holds, computes and moves, and the roofline the card
gives it.

For each cell one rank (rank 0) of a ``fake`` process group of the mesh's
size (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, moving nothing) runs the port's own step on meta tensors:
``runtime/train_step.py::sharded_train_step`` for a train cell,
``runtime/serve_step.py::sharded_prefill_step`` / ``sharded_decode_step``
for a prefill or decode cell, over its blocks of the weights, the AdamW
moments and the cache, with the process groups of
``launch/mesh.py::_build_groups``. No card is touched and none is needed:
meta tensors carry shapes and dtypes only, and the kernels take their
shape-only routes (``kernels/meta.py``). Each cell gives a JSON under
``build/dryrun/<mesh>/`` (``<arch>__<shape>.json``, and
``<arch>__<shape>__w8a8[_prequant].json`` in the other modes) holding, per
rank:

  * the argument bytes: the rank's blocks of the params, the optimizer
    state and the cache (exact: the blocks are the ones a real rank
    allocates);
  * the peak of live bytes during the step, from a dispatch-mode tracker
    of every tensor storage an op makes (:class:`LiveBytes`; the
    arguments included, the caching allocator's rounding not);
  * the FLOPs of every matrix product (``FlopCounterMode``, the kernels'
    formulas included);
  * the collectives' calls and bytes by kind
    (``distributed/collectives.py``), and by the mesh axes of their group;
  * the dry run's own wall seconds, and ``core/roofline.py``'s terms.

The reference parses its collectives out of the compiled HLO
(``_shape_bytes``, ``_group_size``, ``_split_computations``,
``_execution_multipliers``, ``parse_collectives``). The port has no HLO:
its collectives are the calls the step makes, counted as they run, so
nothing here parses, and a loop's trips are counted by running them.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --all --fast   # skip cells done
  python -m repro_torch.launch.dryrun --table        # the records' table
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.core import roofline
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import adamw
from repro_torch.runtime import serve_step as SS
from repro_torch.runtime import train_step as TS

OUT_DIR = os.path.join(os.path.dirname(__file__), '..', '..', '..', 'build',
                       'dryrun')
# grad-accumulation per train cell: microbatching keeps the activation
# working set ~1/A; the global microbatch still divides both meshes' dp
# extents (16 and 32)
TRAIN_GRAD_ACCUM = roofline.TRAIN_GRAD_ACCUM
META = torch.device('meta')


# ----------------------------------------------------------------------------
# inputs (meta tensors; no allocation)
# ----------------------------------------------------------------------------
def input_specs(cfg, shape_name: str = None, *, shape: dict = None) -> dict:
    """The cell's global inputs, as the reference's ``input_specs``: a
    train batch (``inputs``, ``labels``), a prefill's ``inputs``, or a
    decode step's ``token`` and 0-d ``pos``; ``shape`` (a dict like
    ``configs.SHAPES``' entries) instead of a named shape."""
    sh = shape or configs.SHAPES[shape_name]
    b, s = sh['global_batch'], sh['seq_len']

    def ids(*shape):
        return torch.empty(shape, dtype=torch.int64, device=META)

    if cfg.input_kind == 'embeddings':
        def inputs(*shape):
            return torch.empty(shape + (cfg.d_model,), dtype=torch.bfloat16,
                               device=META)
    elif cfg.input_kind == 'codebooks':
        def inputs(*shape):
            return ids(*shape, cfg.n_codebooks)
    else:
        inputs = ids
    if sh['kind'] == 'train':
        labels = ids(b, s, cfg.n_codebooks) if \
            cfg.input_kind == 'codebooks' else ids(b, s)
        return dict(inputs=inputs(b, s), labels=labels)
    if sh['kind'] == 'prefill':
        return dict(inputs=inputs(b, s))
    return dict(token=inputs(b),
                pos=torch.empty((), dtype=torch.int32, device=META))


# ----------------------------------------------------------------------------
# live bytes
# ----------------------------------------------------------------------------
#: the device copies gloo makes inside a collective on CUDA tensors
#: (ranks that share a card): the op and the argument whose bytes it
#: copies. A reduce-scatter clones its whole input before it all-reduces
#: it through host memory, an all-gather stages its whole output; its
#: all-reduce and all-to-all stage through pinned host memory only
#: (tools/gloo_staging_probe.py reads each on the card). NCCL makes no
#: such copy through the caching allocator.
GLOO_CUDA_STAGING = {'_reduce_scatter_base_': 1, '_allgather_base_': 0}


class LiveBytes(TorchDispatchMode):
    """The bytes of the tensor storages alive while the mode is on, and
    their peak: each storage an op's output holds counted once, from the
    op that made it until it is freed (a weak reference's callback), the
    storages of ``args`` (the step's arguments) counted from the start.
    Works on the meta device, where storages have sizes and no memory.
    ``staging`` ({op name: argument index}, e.g. GLOO_CUDA_STAGING) adds a
    copy of that argument, alive for the op's call alone, to ``peak``."""

    def __init__(self, args=(), staging=None):
        super().__init__()
        self.refs = {}
        self.live = 0
        self.peak = 0
        self.staging = staging or {}
        for t in args:
            self._add(t)

    def _add(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.refs:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self.refs.pop(key, None) is not None:
                self.live -= n
        self.refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        staged = self.staging.get(func._opname)
        if staged is not None:
            t = args[staged]
            self.peak = max(self.peak,
                            self.live + t.numel() * t.element_size())
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            self._add(t)
        return out


# ----------------------------------------------------------------------------
# the fake world
# ----------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(mesh):
    """Rank 0 of a ``fake`` process group of the mesh's size, the mesh's
    groups built (``launch/mesh.py::_build_groups``); the group is
    destroyed on the way out, leaving ``torch.distributed`` as it was
    found. Refuses to start inside an initialised group."""
    if dist.is_initialized():
        raise RuntimeError('the dry run makes its own process group; call '
                           'it outside an initialised torch.distributed '
                           'group')
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        mesh = mesh_mod.RankMesh(dict(mesh.shape), rank=0, device=META)
        mesh_mod._build_groups(mesh)
        yield mesh
    finally:
        dist.destroy_process_group()


def _group_axes(mesh) -> dict:
    return {id(g): axes for axes, g in mesh.groups.items()}


def collective_record(mesh) -> dict:
    """:mod:`collectives`' counts since the last reset: calls and bytes by
    kind, and the bytes by kind and mesh axes of their group."""
    axes_of = _group_axes(mesh)
    by_axes = []
    for (kind, group), n in sorted(
            collectives.GROUP_BYTES.items(),
            key=lambda kv: (kv[0][0], axes_of.get(id(kv[0][1]), ()))):
        axes = axes_of[id(group)]
        by_axes.append(dict(
            kind=kind, axes=list(axes), group_size=mesh.axis_size(axes),
            bytes=n, wire_bytes=roofline.wire_bytes(
                kind, n, mesh.axis_size(axes)),
            crosses_nodes=roofline.crosses_nodes(mesh.shape, axes)))
    return dict(calls={k: v for k, v in collectives.CALLS.items()
                       if k not in collectives.SERVING or v},
                bytes=dict(collectives.BYTES), by_axes=by_axes,
                total_bytes=sum(collectives.BYTES.values()),
                wire_bytes=sum(e['wire_bytes'] for e in by_axes))


# ----------------------------------------------------------------------------
# per-cell dry run
# ----------------------------------------------------------------------------
def _build_step(mesh, cfg, sh, yoco, *, layout, grad_accum, remat,
                prequant, attn_impl):
    """(run, args, arg_bytes): a closure running the cell's step once on
    this rank's meta blocks, the step's tensors and their bytes."""
    b, s = sh['global_batch'], sh['seq_len']
    ins = input_specs(cfg, shape=sh)
    if sh['kind'] == 'train':
        opt_cfg = adamw.OptConfig(grad_accum=grad_accum)
        step, (pabs, oabs) = TS.sharded_train_step(
            mesh, cfg, yoco, opt_cfg=opt_cfg, layout=layout, remat=remat)
        pspecs, _, _ = TS.state_shardings(mesh, cfg, pabs, oabs, layout)
        blocks = sharding.shard_tree(pabs, pspecs, mesh)
        state = adamw.init(blocks, opt_cfg)
        arg = dict(params=sharding.nbytes(blocks),
                   opt=sharding.nbytes([state.mu, state.nu]), cache=0)
        tensors = adamw.tree_leaves([blocks, state.mu, state.nu]) + \
            list(ins.values())
        return (lambda: step(blocks, state, ins)), tensors, arg
    kw = dict(yoco=yoco, layout=layout, prequant=prequant,
              attn_impl=attn_impl)
    max_seq = sh.get('max_seq', s)
    if sh['kind'] == 'prefill':
        step, (pabs, cabs) = SS.sharded_prefill_step(mesh, cfg, b,
                                                     max_seq, **kw)
    else:
        step, (pabs, cabs) = SS.sharded_decode_step(mesh, cfg, b, max_seq,
                                                    **kw)
    pspecs, cspecs = step.specs
    blocks = sharding.shard_tree(pabs, pspecs, mesh)
    cache = sharding.zeros_blocks(cabs, cspecs, mesh, META)
    arg = dict(params=sharding.nbytes(blocks), opt=0,
               cache=sharding.nbytes(cache))
    tensors = adamw.tree_leaves([blocks, cache]) + list(ins.values())
    if sh['kind'] == 'prefill':
        return (lambda: step(blocks, ins, cache)), tensors, arg
    return (lambda: step(blocks, ins['token'], ins['pos'], cache)), \
        tensors, arg


def dryrun_step(cfg, shape: dict, mesh, *, layout: str = 'tp',
                grad_accum: int = TRAIN_GRAD_ACCUM, remat: str = 'full',
                yoco_mode: str = 'bf16', prequant: bool = False,
                attn_impl: str = 'einsum', staging=None) -> dict:
    """One rank's step of ``cfg`` at ``shape`` (``kind``, ``global_batch``,
    ``seq_len``, and for a serve cell optionally ``max_seq``, the cache's
    length, default ``seq_len``) on ``mesh`` (a shape-only ``RankMesh``),
    on the meta device: the record's measured part (argument bytes,
    memory, FLOPs, collectives, seconds). ``staging`` as
    :class:`LiveBytes`' (default: none, as over NCCL)."""
    sh = shape
    yoco = YocoConfig(mode=yoco_mode)
    t0 = time.time()
    with fake_world(mesh) as mesh:
        run, tensors, arg = _build_step(
            mesh, cfg, sh, yoco, layout=layout, grad_accum=grad_accum,
            remat=remat, prequant=prequant, attn_impl=attn_impl)
        collectives.reset_counts()
        live = LiveBytes(tensors, staging)
        with FlopCounterMode(display=False) as flops, live:
            run()
        coll = collective_record(mesh)
    arg['total'] = arg['params'] + arg['opt'] + arg['cache']
    return dict(
        mesh_shape=dict(mesh.shape), kind=sh['kind'],
        seq_len=sh['seq_len'], global_batch=sh['global_batch'],
        grad_accum=grad_accum if sh['kind'] == 'train' else 1,
        layout=layout, remat=remat, yoco_mode=yoco_mode, prequant=prequant,
        attn_impl=attn_impl, n_chips=mesh.size,
        params=int(cfg.param_count()),
        active_params=int(cfg.active_param_count()),
        argument_bytes=arg,
        memory=dict(argument_bytes=arg['total'], peak_bytes=live.peak),
        flops=int(flops.get_total_flops()), collectives=coll,
        dryrun_s=time.time() - t0)


def dryrun_cell(arch: str, shape_name: str, mesh_kind: str,
                verbose: bool = True, *, layout: str = 'tp',
                grad_accum: int = TRAIN_GRAD_ACCUM, remat: str = 'full',
                yoco_mode: str = 'bf16', prequant: bool = False) -> dict:
    """One cell's record on the production mesh of ``mesh_kind``, with
    ``core/roofline.py``'s terms."""
    mesh = mesh_mod.make_production_mesh(multi_pod=(mesh_kind == 'multi'))
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind)
    rec.update(dryrun_step(
        configs.get(arch), dict(configs.SHAPES[shape_name]), mesh,
        layout=layout, grad_accum=grad_accum, remat=remat,
        yoco_mode=yoco_mode, prequant=prequant))
    arg, live_peak, coll = (rec['argument_bytes'],
                            rec['memory']['peak_bytes'], rec['collectives'])
    rec['roofline'] = roofline.roofline_terms(
        arch, shape_name, rec, int8=yoco_mode == 'w8a8')
    if verbose:
        print(f"[ok] {arch} x {shape_name} x {mesh_kind}: "
              f"{rec['dryrun_s']:.1f}s, flops/rank {rec['flops']:.3e}, "
              f"args {arg['total'] / 2**30:.2f} GiB, peak "
              f"{live_peak / 2**30:.2f} GiB, collectives "
              f"{coll['total_bytes'] / 2**30:.3f} GiB/rank, "
              f"{rec['roofline']['dominant']}")
    return rec


def cell_list(mesh_kind: str):
    for arch in configs.names():
        cfg = configs.get(arch)
        for shape_name in configs.SHAPES:
            if configs.cell_is_live(cfg, shape_name):
                yield arch, shape_name, mesh_kind


#: a rank's memory: an H100's 80 GB (80e9 B; the card holds a little more)
CARD_BYTES = 80e9


def table(out_dir: str = OUT_DIR, mode: str = '') -> str:
    """The records under ``out_dir`` as a markdown table, one row per live
    cell, each figure ``single / multi``: a rank's argument and peak GB,
    TFLOPs, the collectives' GB by kind (gathered, reduce-scattered,
    all-reduced, exchanged), the three roofline terms in seconds and the
    dominant one; then the cells whose peak exceeds ``CARD_BYTES``. A
    cell without both records is left out."""
    def load(arch, shape, mesh):
        path = os.path.join(out_dir, mesh, f'{arch}__{shape}{mode}.json')
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def both(fn, fmt):
        return ' / '.join(format(fn(r), fmt) for r in recs)
    lines = ['| config | shape | args GB | peak GB | TFLOP | AG / RS / AR / '
             'A2A GB | compute s | memory s | collective s | dominant |',
             '| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |']
    over = []
    for arch, shape, _ in cell_list('single'):
        recs = [load(arch, shape, m) for m in ('single', 'multi')]
        if None in recs:
            continue
        kinds = ' ; '.join(
            ' / '.join(format(r['collectives']['bytes'][k] / 1e9, '.3g')
                       for k in ('all_gather', 'reduce_scatter',
                                 'all_reduce', 'all_to_all'))
            for r in recs)
        dom = ' / '.join(r['roofline']['dominant'][:-2] for r in recs)
        lines.append(
            f"| {arch} | {shape} | "
            f"{both(lambda r: r['argument_bytes']['total'] / 1e9, '.3g')} | "
            f"{both(lambda r: r['memory']['peak_bytes'] / 1e9, '.3g')} | "
            f"{both(lambda r: r['flops'] / 1e12, '.4g')} | {kinds} | "
            f"{both(lambda r: r['roofline']['compute_s'], '.3g')} | "
            f"{both(lambda r: r['roofline']['memory_s'], '.3g')} | "
            f"{both(lambda r: r['roofline']['collective_s'], '.3g')} | "
            f"{dom} |")
        over += [f'{arch} {shape} {r["mesh"]}' for r in recs
                 if r['memory']['peak_bytes'] > CARD_BYTES]
    lines.append('')
    lines.append(f'Peak above {CARD_BYTES / 1e9:.0f} GB a rank: '
                 + (', '.join(over) or 'none') + '.')
    return '\n'.join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch')
    ap.add_argument('--shape')
    ap.add_argument('--mesh', default='both',
                    choices=['single', 'multi', 'both'])
    ap.add_argument('--all', action='store_true')
    ap.add_argument('--fast', action='store_true',
                    help='skip cells with an existing record')
    ap.add_argument('--out', default=OUT_DIR)
    ap.add_argument('--layout', default='tp', choices=['tp', 'fsdp2d'])
    ap.add_argument('--accum', type=int, default=TRAIN_GRAD_ACCUM)
    ap.add_argument('--remat', default='full', choices=['full', 'none'])
    ap.add_argument('--yoco-mode', default='bf16', choices=['bf16', 'w8a8'])
    ap.add_argument('--prequant', action='store_true',
                    help='serve cells: int8 weights resident (in-situ)')
    ap.add_argument('--tag', default='',
                    help='write the record to <out>/../perf/<cell>__<tag>')
    ap.add_argument('--table', action='store_true',
                    help='print the records of every live cell as a '
                         'markdown table, run nothing')
    args = ap.parse_args(argv)

    # a mode's records beside bf16's: <cell>__w8a8[_prequant].json
    mode = '' if args.yoco_mode == 'bf16' and not args.prequant else \
        f'__{args.yoco_mode}' + ('_prequant' if args.prequant else '')
    if args.table:
        print(table(args.out, mode))
        return
    meshes = ['single', 'multi'] if args.mesh == 'both' else [args.mesh]
    cells = []
    for mk in meshes:
        if args.all:
            cells += list(cell_list(mk))
        else:
            if not (args.arch and args.shape):
                ap.error('--arch and --shape, or --all')
            cells.append((args.arch, args.shape, mk))

    t0 = time.time()
    failures = []
    for arch, shape_name, mk in cells:
        if args.tag:
            out_dir = os.path.join(args.out, '..', 'perf')
            path = os.path.join(out_dir,
                                f'{arch}__{shape_name}__{args.tag}.json')
        else:
            out_dir = os.path.join(args.out, mk)
            path = os.path.join(out_dir, f'{arch}__{shape_name}{mode}.json')
        os.makedirs(out_dir, exist_ok=True)
        if args.fast and os.path.exists(path):
            print(f'[skip] {arch} x {shape_name} x {mk}')
            continue
        try:
            rec = dryrun_cell(arch, shape_name, mk, layout=args.layout,
                              grad_accum=args.accum, remat=args.remat,
                              yoco_mode=args.yoco_mode,
                              prequant=args.prequant)
            rec['tag'] = args.tag
            with open(path, 'w') as f:
                json.dump(rec, f, indent=1)
        except Exception as e:   # noqa: BLE001 — report all failures at end
            traceback.print_exc()
            failures.append((arch, shape_name, mk, repr(e)))
    if failures:
        print('\nFAILURES:')
        for f in failures:
            print(' ', f)
        sys.exit(1)
    print(f'\nall {len(cells)} cells passed in {time.time() - t0:.1f} s')


if __name__ == '__main__':
    main()
