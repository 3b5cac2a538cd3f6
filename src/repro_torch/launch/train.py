"""Fault-tolerant training launcher (port of ``repro/launch/train.py``).

Drives :func:`repro_torch.runtime.train_step.make_train_step` with:
auto-resume from the latest checkpoint, asynchronous atomic checkpoints
every N steps, a step-time watchdog (straggler detection), the stateless
synthetic data stream (a resumed step sees the batch it saw before), and a
failure-injection flag that kills the process at a chosen step, before
that step's save, to exercise the restart path.

Weights are drawn from ``--seed`` on the device; the f32 linear masters
are stored K-major (``models.model.k_major_linear_weights``), the layout
kernels K3 and K4 read in every mode. Runs on the card unless
``--device cpu`` is given (then the kernels' plain versions run).

Usage:
  python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
      --steps 50 --ckpt-every 10 --ckpt-dir runs/run1 [--device cpu]
  # kill it at any point, rerun the same command: it resumes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.core.yoco_linear import MODES, YocoConfig
from repro_torch.data import synthetic
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as TS


class StepWatchdog:
    """Flags straggling steps (> ``factor`` x the median of the recent
    ``window`` steps, once 5 are known) and counts them."""

    def __init__(self, factor: float = 3.0, window: int = 20):
        self.times = []
        self.factor = factor
        self.window = window
        self.straggler_events = 0

    def observe(self, dt: float) -> bool:
        slow = (len(self.times) >= 5
                and dt > self.factor * statistics.median(
                    self.times[-self.window:]))
        self.times.append(dt)
        if slow:
            self.straggler_events += 1
        return slow


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), 'repro_torch_ckpt')


def init_state(cfg, opt_cfg: adamw.OptConfig, seed: int, device):
    """(f32 masters drawn from ``seed`` on ``device``, linears K-major;
    zero AdamW state)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model_mod.k_major_linear_weights(
        model_mod.init_params(gen, cfg, device=device))
    return params, adamw.init(params, opt_cfg)


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          global_batch: int = 8, seq_len: int = 64, lr: float = 1e-3,
          grad_accum: int = 1, ckpt_every: int = 10,
          ckpt_dir: str = None, mode: str = 'bf16',
          simulate_failure_at: int = -1, log_every: int = 10,
          seed: int = 0, quiet: bool = False, device=None) -> dict:
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s latest
    checkpoint), save every ``ckpt_every`` steps and at the end; returns
    dict(final_loss, first_loss, steps_run, straggler_events, history).
    Each step's time is taken after the device finished it."""
    device = device_mod.resolve(device)
    ckpt_dir = ckpt_dir or default_ckpt_dir()
    cfg = configs.get(arch, smoke=smoke)
    yoco = YocoConfig(mode=mode)
    opt_cfg = adamw.OptConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                              total_steps=steps, grad_accum=grad_accum)
    dc = synthetic.for_arch(cfg, seed=1234 + seed, global_batch=global_batch,
                            seq_len=seq_len)
    params, opt_state = init_state(cfg, opt_cfg, seed, device)
    step_fn = TS.make_train_step(cfg, yoco, opt_cfg=opt_cfg)

    mgr = CheckpointManager(ckpt_dir, keep=3)
    start = 0
    if mgr.latest_step() is not None:
        (params, opt_state), manifest = mgr.restore((params, opt_state))
        start = manifest['step']
        if not quiet:
            print(f'[resume] restored step {start} from {ckpt_dir}')

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    wd = StepWatchdog()
    history = []
    for step in range(start, steps):
        batch = {k: v.to(device) for k, v in
                 synthetic.make_batch(dc, step).items()}
        sync()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        sync()
        dt = time.perf_counter() - t0
        loss = float(metrics['loss'])
        slow = wd.observe(dt)
        history.append(loss)
        if not quiet and (step % log_every == 0 or step == steps - 1):
            print(f'step {step:5d} loss {loss:.4f} '
                  f'gnorm {float(metrics["grad_norm"]):.3f} '
                  f'lr {float(metrics["lr"]):.2e} {dt*1e3:.0f} ms'
                  + (' [STRAGGLER]' if slow else ''), flush=True)
        if simulate_failure_at == step:
            mgr.wait()                      # die BEFORE this step's save
            print(f'[failure-sim] dying at step {step}', flush=True)
            os._exit(17)                    # hard kill mid-interval
        if ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state),
                     extra=dict(loss=loss, arch=arch))
    mgr.wait()
    mgr.save(steps, (params, opt_state), extra=dict(loss=history[-1],
                                                    arch=arch))
    mgr.wait()
    return dict(final_loss=history[-1], first_loss=history[0],
                steps_run=len(history), straggler_events=wd.straggler_events,
                history=history)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='stablelm-1.6b')
    ap.add_argument('--smoke', action='store_true', default=True)
    ap.add_argument('--full', dest='smoke', action='store_false')
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--global-batch', type=int, default=8)
    ap.add_argument('--seq-len', type=int, default=64)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--grad-accum', type=int, default=1)
    ap.add_argument('--ckpt-every', type=int, default=10)
    ap.add_argument('--ckpt-dir', default=None,
                    help='default: repro_torch_ckpt under the temp dir')
    ap.add_argument('--mode', default='bf16', choices=list(MODES))
    ap.add_argument('--simulate-failure-at', type=int, default=-1)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help='default: the CUDA card; "cpu" runs the plain '
                         'versions of the kernels')
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                global_batch=args.global_batch, seq_len=args.seq_len,
                lr=args.lr, grad_accum=args.grad_accum,
                ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                mode=args.mode, seed=args.seed,
                simulate_failure_at=args.simulate_failure_at,
                device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != 'history'}))


if __name__ == '__main__':
    main()
