"""Atomic, optionally asynchronous checkpoints (port of
``repro/checkpoint/ckpt.py``), in the reference's format.

* Every checkpoint is a directory ``step_<n>/`` holding ``arrays.npz`` (one
  array a leaf) and ``manifest.json`` (step, time, extra, each leaf's
  shape and dtype, the devices that wrote it).
* A save writes ``step_<n>.tmp/`` and publishes it with one atomic
  ``os.rename``: a process dying mid-write never leaves a restorable
  half checkpoint. ``keep`` bounds the checkpoints kept (the oldest go).
* With ``async_save`` the device-to-host copy happens in :meth:`save`
  itself, so training may write its tensors right after, and the
  serialization runs on a background thread, joined before the next save.

Keys are the reference's: a path of dict keys, tuple indices and
NamedTuple field names joined by ``/`` (``0/layers/attn/wq``, ``1/step``,
``1/mu/embed``), and each list of the port's tree (its per-layer lists)
stacked into one leading (L, ...) axis, as ``models.model.params_to_numpy``
stacks it. So a checkpoint written by either package restores in the
other. :meth:`CheckpointManager.restore` copies each array into the
template's tensor in place: the template's dtypes, devices and strides (a
K-major linear master, an expert stack's layout) are kept.

A sharded state (a rank mesh's blocks, ``runtime/train_step.py``) saves
as the same global arrays: :func:`save_sharded` gathers the whole leaves
on every rank and rank 0 writes them. :func:`restore_sharded` reads them
into a whole template and cuts the blocks of the mesh it restores on,
which may be another shape or layout than the one that saved (the
reference's elastic restore: the manifest holds global shapes).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

MANIFEST = 'manifest.json'


# ----------------------------------------------------------------------------
# tree <-> flat dict of arrays
# ----------------------------------------------------------------------------
def _items(node):
    """A node's (key, child) pairs, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return list(zip(node._fields, node))
    if isinstance(node, tuple):
        return list(enumerate(node))
    return None


def _join(prefix: str, key) -> str:
    return f'{prefix}/{key}' if prefix else str(key)


def _host(t) -> np.ndarray:
    """A copy of a leaf's values on the host, C-ordered (bf16 as f32):
    training may write the tensor while the copy is being saved."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to('cpu', copy=True)
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.contiguous().numpy()
    return np.array(t, order='C')


def _flatten(tree, prefix: str = '') -> dict:
    if tree is None:
        return {}
    if isinstance(tree, list):
        parts = [_flatten(v) for v in tree]
        return {_join(prefix, k): np.stack([p[k] for p in parts])
                for k in parts[0]}
    items = _items(tree)
    if items is None:
        return {prefix: _host(tree)}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, _join(prefix, k)))
    return flat


@torch.no_grad()
def _fill(template, flat: dict, prefix: str = '', index: tuple = ()):
    """Copy each array of ``flat`` into the matching tensor of
    ``template`` (a list's element ``i`` reads row ``i`` of the stacked
    array)."""
    if template is None:
        return
    if isinstance(template, list):
        for i, v in enumerate(template):
            _fill(v, flat, prefix, index + ((i, len(template)),))
        return
    items = _items(template)
    if items is not None:
        for k, v in items:
            _fill(v, flat, _join(prefix, k), index)
        return
    if prefix not in flat:
        raise KeyError(f'checkpoint missing leaf {prefix!r}')
    arr = flat[prefix]
    want = tuple(n for _, n in index) + tuple(np.shape(template))
    if tuple(arr.shape) != want:
        raise ValueError(
            f'leaf {prefix!r}: checkpoint shape {arr.shape} != model shape '
            f'{want} — architecture mismatch')
    row = arr[tuple(i for i, _ in index)]
    template.copy_(torch.from_numpy(np.array(row)))


# ----------------------------------------------------------------------------
# manager
# ----------------------------------------------------------------------------
class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        """Snapshot ``tree`` (copied to the host here, synchronously);
        serialize it on the background thread with ``async_save``."""
        self.wait()                                   # one save in flight
        flat = _flatten(tree)
        manifest = dict(
            step=step, time=time.time(), extra=extra or {},
            leaves={k: dict(shape=list(v.shape), dtype=str(v.dtype))
                    for k, v in flat.items()},
            n_devices=max(torch.cuda.device_count(), 1))
        path = os.path.join(self.dir, f'step_{step:08d}')

        def write():
            tmp = path + '.tmp'
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, 'arrays.npz'), **flat)
            with open(os.path.join(tmp, MANIFEST), 'w') as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)                      # atomic publish
            self._gc()

        if self.async_save:
            def background():
                try:
                    write()
                except BaseException as e:      # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()
        else:
            write()
        return path

    def wait(self):
        """Join the save in flight; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f'step_{s:08d}'),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith('step_') and not name.endswith('.tmp') \
                    and os.path.exists(os.path.join(self.dir, name, MANIFEST)):
                out.append(int(name.split('_')[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple:
        """Returns (template, manifest): every tensor of ``template`` holds
        the checkpoint's values (the latest step by default), copied in
        place. Raises ``KeyError`` on a leaf the checkpoint lacks and
        ``ValueError`` on a shape that differs."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoints in {self.dir}')
        path = os.path.join(self.dir, f'step_{step:08d}')
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, 'arrays.npz')) as z:
            flat = {k: z[k] for k in z.files}
        _fill(template, flat)
        return template, manifest


# ----------------------------------------------------------------------------
# sharded states
# ----------------------------------------------------------------------------
def save_sharded(mgr: CheckpointManager, step: int, tree: Any, specs: Any,
                 mesh, extra: Optional[dict] = None) -> Optional[str]:
    """Every rank calls it: the blocks of ``tree`` under ``specs`` are
    gathered whole (``sharding.unshard_tree``), rank 0 saves the global
    arrays and waits for the write, and no rank returns before it is
    written (a barrier), so any rank may restore it next. Returns rank
    0's path."""
    from repro_torch.distributed import sharding
    whole = sharding.unshard_tree(tree, specs, mesh)
    path = None
    if mesh.rank == 0:
        path = mgr.save(step, whole, extra)
        mgr.wait()
    if mesh.size > 1:
        dist.barrier(group=mesh.group(mesh.axis_names))
    return path


def restore_sharded(mgr: CheckpointManager, template: Any, specs: Any,
                    mesh, step: Optional[int] = None) -> tuple:
    """(this rank's blocks under ``specs`` on ``mesh``, manifest): the
    checkpoint's global arrays read into the whole ``template`` (any
    device), then cut."""
    from repro_torch.distributed import sharding
    whole, manifest = mgr.restore(template, step)
    return sharding.shard_tree(whole, specs, mesh), manifest


def sharded_restore_job(shard, *, cfg, params, batch, ckpt_dir: str,
                        opt_cfg) -> dict:
    """A rank job (``distributed/ranks.py``): one sharded step of ``cfg``
    from ``params`` (numpy) on a 2 x (n / 2) mesh under the 'tp' layout,
    saved with :func:`save_sharded`; then restored onto an n x 1 mesh
    under 'fsdp2d' and one more step taken there. Returns whether every
    restored block equals that mesh's cut of the saved whole state, and
    both steps' losses."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_mod
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as ts
    first, second = shard.mesh(2), shard.mesh(1)
    dev = shard.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    out = {}
    specs = {}
    for name, mesh, layout in (('saved', first, 'tp'),
                               ('restored', second, 'fsdp2d')):
        step, (pabs, oabs) = ts.sharded_train_step(
            mesh, cfg, opt_cfg=opt_cfg, layout=layout, remat='none')
        pspecs, ospecs, _ = ts.state_shardings(mesh, cfg, pabs, oabs,
                                               layout)
        specs[name] = (pspecs, ospecs)
        if name == 'saved':
            whole = model_mod.k_major_linear_weights(
                model_mod.params_from_numpy(params, cfg, dev))
            blocks = sharding.shard_tree(whole, pspecs, mesh)
            state = adamw.init(blocks, opt_cfg)
        else:
            template = train_mod.init_state(cfg, opt_cfg, 1, dev)
            (blocks, state), manifest = restore_sharded(
                CheckpointManager(ckpt_dir, async_save=False), template,
                (pspecs, ospecs), mesh)
            saved = sharding.unshard_tree(kept, specs['saved'], first)
            cut = sharding.shard_tree(saved, (pspecs, ospecs), mesh)
            out['blocks_equal'] = all(
                torch.equal(a, b) for a, b in zip(
                    adamw.tree_leaves((blocks, state)),
                    adamw.tree_leaves(cut)))
            out['manifest_step'] = manifest['step']
        blocks, state, m = step(blocks, state, batch)
        out[f'{name}_loss'] = float(m['loss'])
        if name == 'saved':
            save_sharded(CheckpointManager(ckpt_dir, async_save=False), 1,
                         (blocks, state), (pspecs, ospecs), mesh)
            kept = (blocks, state)
    return out
