"""Rank processes for tensor-parallel serving and sharded training: one
process a rank, in one ``torch.distributed`` group.

The caller of :func:`run` is rank 0. It starts ranks 1 .. tp-1 with the
``spawn`` start method (never ``fork``: a caller with JAX or CUDA state
must not be copied), and every rank joins the group through a ``file://``
rendezvous in a fresh temporary directory, so concurrent groups on one
host never share a port. Each rank then runs the same jobs, in order: a
job is ``('module:function', kwargs)``, called as ``function(shard,
**kwargs)`` with the rank's :class:`Shard`, and the function is imported
by name in every rank. :func:`run` returns rank 0's results.

Placement (:func:`placement`): rank r runs on ``cuda:(r % count)``, or on
the CPU when the caller passes ``device='cpu'``. The group is ``nccl``
when every rank has a card of its own, ``gloo`` on the CPU and when ranks
share a card (NCCL refuses two ranks on one device; gloo stages a CUDA
tensor's collective through host memory). Nothing falls back to the CPU:
with no card and no ``device='cpu'`` the placement raises, as
``device.resolve`` does.

The ranks share the host's cores: each runs ``1/tp`` of the caller's
intra-op threads (rank 0 for the run's length), since a rank waiting in a
collective would otherwise spin its whole pool against the others' (at
tp = 2 on 8 cores, a smoke serve took 9x longer).

A mesh job (:func:`mesh_job`) runs its function on the rank's
:class:`repro_torch.launch.mesh.RankMesh` instead of its shard: the mesh
over the group's ranks (data = world / n_model, model = n_model) with its
axis groups, made once a shard and n_model, by every rank in job order.

A failure anywhere fails the run: a worker that raises sends its
traceback back and exits, a rank waiting in a collective on it then
fails, and rank 0 stops every worker and raises with the worker's
traceback.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as device_mod

#: the most a collective waits on a peer before the group fails
TIMEOUT_S = 600


@dataclasses.dataclass
class Shard:
    """One rank's place in the group: ``rank`` of ``tp``, its ``device``,
    the group's ``backend``, and ``group`` (the process group, None until
    the rank has joined)."""
    rank: int
    tp: int
    device: torch.device
    backend: str
    group: Any = None
    meshes: dict = dataclasses.field(default_factory=dict)

    def mesh(self, n_model: int):
        """The group's ranks as a (data, model = n_model) rank mesh, made
        on first use (every rank makes its groups in the same order)."""
        if n_model not in self.meshes:
            from repro_torch.launch import mesh as mesh_mod
            self.meshes[n_model] = mesh_mod.make_host_mesh(
                n_model, device=self.device)
        return self.meshes[n_model]


def placement(tp: int, device=None) -> Tuple[List[torch.device], str]:
    """(every rank's device, the group's backend) for ``tp`` ranks."""
    dev = device_mod.resolve(device)
    if dev.type != 'cuda':
        return [dev] * tp, 'gloo'
    n = torch.cuda.device_count()
    devs = [torch.device('cuda', r % n) for r in range(tp)]
    return devs, ('nccl' if len(set(devs)) == tp else 'gloo')


def mesh_job(target: str, n_model: int, **kwargs) -> Tuple[str, dict]:
    """A job that calls ``target`` as ``function(mesh, **kwargs)`` with
    the rank's mesh (:meth:`Shard.mesh`)."""
    return ('repro_torch.distributed.ranks:_on_mesh',
            dict(target=target, n_model=n_model, kwargs=kwargs))


def _on_mesh(shard: Shard, *, target: str, n_model: int, kwargs: dict):
    return _job_fn(target)(shard.mesh(n_model), **kwargs)


def all_ranks_job(job: Tuple[str, dict]) -> Tuple[str, dict]:
    """A job whose result is every rank's result of ``job``, in rank
    order (picklable results, gathered after the job)."""
    return ('repro_torch.distributed.ranks:_all_ranks', dict(job=job))


def _all_ranks(shard: Shard, *, job):
    from repro_torch.distributed import collectives
    target, kwargs = job
    return collectives.gather_objects(_job_fn(target)(shard, **kwargs),
                                      shard.group)


def _job_fn(target: str):
    module, name = target.split(':')
    return getattr(importlib.import_module(module), name)


def _join(shard: Shard, store) -> None:
    kw = {}
    if shard.device.type == 'cuda':
        torch.cuda.set_device(shard.device)
        if shard.backend == 'nccl':
            kw['device_id'] = shard.device
    dist.init_process_group(shard.backend, store=store, rank=shard.rank,
                            world_size=shard.tp,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)
    shard.group = dist.group.WORLD


def _await_workers(store, procs, errors) -> None:
    """Wait until every spawned rank has reached the rendezvous, failing
    as soon as one has died on the way (an import error, say) instead of
    at the group's timeout."""
    keys = [f'ready{r}' for r in range(1, len(procs) + 1)]
    deadline = time.monotonic() + TIMEOUT_S
    while not store.check(keys):
        dead = [(r, p.exitcode) for r, p in enumerate(procs, 1)
                if p.exitcode is not None]
        if dead or time.monotonic() > deadline:
            raise RuntimeError(f'tensor-parallel ranks did not reach the '
                               f'rendezvous (rank, exit code): {dead}'
                               f'{_worker_errors(errors)}')
        time.sleep(0.02)


def _run_jobs(shard: Shard, jobs) -> list:
    return [_job_fn(target)(shard, **kwargs) for target, kwargs in jobs]


def _leave(shard: Shard) -> None:
    dist.destroy_process_group()
    shard.group = None


def _worker(shard: Shard, init_file: str, jobs, threads: int,
            errors) -> None:
    """A spawned rank: join, run the jobs, leave. A failure is sent back
    on ``errors`` before the process exits. A rank that succeeded ends
    with ``os._exit(0)``: the interpreter's teardown could otherwise
    destroy a communication thread of the group still running (a
    ``std::terminate``, exit code -6, seen now and then with gloo)."""
    try:
        torch.set_num_threads(threads)
        store = dist.FileStore(init_file, shard.tp)
        store.set(f'ready{shard.rank}', '1')
        _join(shard, store)
        _run_jobs(shard, jobs)
        _leave(shard)
    except BaseException:
        # the tail only: a message past the pipe's buffer would block this
        # rank until rank 0 reads it, and rank 0 joins before it reads
        errors.put((shard.rank, traceback.format_exc()[-16384:]))
        raise
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run(jobs: Sequence[Tuple[str, dict]],
        placed: Tuple[List[torch.device], str], *,
        worker_jobs=None) -> list:
    """Run ``jobs`` on the ranks ``placed`` (:func:`placement`'s result;
    this process is rank 0); returns rank 0's result of each job.
    ``worker_jobs`` (default ``jobs``), one a job, are what the other
    ranks run instead, pickled to them: the same targets with what must
    not or cannot leave rank 0 taken out."""
    if dist.is_initialized():
        raise RuntimeError('a torch.distributed group is already running in '
                           'this process; tensor-parallel serving starts its '
                           'own')
    devs, backend = placed
    tp = len(devs)
    jobs = list(jobs)
    worker_jobs = jobs if worker_jobs is None else list(worker_jobs)
    ctx = torch.multiprocessing.get_context('spawn')
    errors = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix='repro_torch_tp_')
    init_file = os.path.join(tmp, 'rendezvous')
    shards = [Shard(r, tp, devs[r], backend) for r in range(tp)]
    threads = torch.get_num_threads()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(shards[r], init_file, worker_jobs,
                               max(1, threads // tp), errors))
             for r in range(1, tp)]
    joined = False
    torch.set_num_threads(max(1, threads // tp))
    try:
        for p in procs:
            p.start()
        store = dist.FileStore(init_file, tp)
        _await_workers(store, procs, errors)
        _join(shards[0], store)
        joined = True
        out = _run_jobs(shards[0], jobs)
        _leave(shards[0])
        joined = False
        for p in procs:
            p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs, 1)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f'tensor-parallel ranks failed (rank, exit '
                               f'code): {bad}{_worker_errors(errors)}')
        return out
    except BaseException as exc:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join()
        if joined:
            _leave(shards[0])
        # rank 0's own exception goes up unchanged, the workers' beside it
        detail = _worker_errors(errors)
        if detail:
            exc.add_note(f'the other ranks:{detail}')
        raise
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(tmp, ignore_errors=True)


def _worker_errors(errors) -> str:
    msgs = []
    while not errors.empty():
        rank, tb = errors.get()
        msgs.append(f'\n--- rank {rank}:\n{tb}')
    return ''.join(msgs)
