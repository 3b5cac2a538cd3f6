"""The port's trainer (``repro_torch.launch.train``) on the CPU: the
reference's kill-and-resume test (``tests/test_fault_tolerance.py::
test_kill_and_resume_end_to_end``) through the port's CLI, the resumed
losses equal to an uninterrupted run's bit for bit, the watchdog, and the
refusal to train without a card unless the CPU is asked for."""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.launch import train as T

REPO = os.path.join(os.path.dirname(__file__), '..')
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, 'src'))


def test_kill_and_resume_end_to_end(tmp_path):
    """20 steps with a hard kill at step 9: the relaunch resumes from step
    5 and finishes (15 steps run), the last checkpoint is step 20."""
    ckpt = str(tmp_path / 'run')
    cmd = [sys.executable, '-m', 'repro_torch.launch.train', '--device',
           'cpu', '--arch', 'stablelm-1.6b', '--steps', '20',
           '--ckpt-every', '5', '--ckpt-dir', ckpt, '--seq-len', '32',
           '--global-batch', '4']
    r1 = subprocess.run(cmd + ['--simulate-failure-at', '9'],
                        capture_output=True, text=True, env=ENV, cwd=REPO,
                        timeout=300)
    assert r1.returncode == 17, r1.stdout + r1.stderr     # died on purpose
    assert '[failure-sim] dying at step 9' in r1.stdout
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 5                          # survived save
    r2 = subprocess.run(cmd, capture_output=True, text=True, env=ENV,
                        cwd=REPO, timeout=300)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert '[resume] restored step 5' in r2.stdout
    out = json.loads(r2.stdout.strip().splitlines()[-1])
    assert out['steps_run'] == 15                          # 5..20
    assert set(out) == {'final_loss', 'first_loss', 'steps_run',
                        'straggler_events'}
    assert mgr.latest_step() == 20
    assert mgr.all_steps() == [10, 15, 20]                 # keep=3


@pytest.mark.parametrize('mode,accum', (('bf16', 1), ('w8a8', 2)))
def test_resume_reruns_the_same_steps(tmp_path, mode, accum):
    """A run killed after its step-6 checkpoint and relaunched gives the
    uninterrupted run's losses at steps 6-9, bit for bit."""
    kw = dict(smoke=True, steps=10, global_batch=4, seq_len=16,
              grad_accum=accum, mode=mode, quiet=True, device='cpu')
    whole = T.train('stablelm-1.6b', ckpt_every=0,
                    ckpt_dir=str(tmp_path / 'whole'), **kw)
    ckpt = str(tmp_path / 'run')
    code = ('from repro_torch.launch import train as T; '
            f'T.train("stablelm-1.6b", ckpt_every=3, ckpt_dir={ckpt!r}, '
            f'simulate_failure_at=6, **{kw!r})')
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=ENV, cwd=REPO, timeout=300)
    assert r.returncode == 17, r.stdout + r.stderr
    assert CheckpointManager(ckpt).latest_step() == 6
    rest = T.train('stablelm-1.6b', ckpt_every=3, ckpt_dir=ckpt, **kw)
    assert rest['steps_run'] == 4
    assert rest['history'] == whole['history'][6:]
    assert whole['history'][-1] < whole['history'][0]


def test_train_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is visible: train() runs on it by default')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.train('stablelm-1.6b', steps=1, ckpt_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_step_watchdog_flags_stragglers():
    wd = T.StepWatchdog(factor=3.0, window=20)
    assert [wd.observe(t) for t in (1.0, 1.1, 0.9, 1.0, 1.0)] == [False] * 5
    assert wd.observe(3.5) and not wd.observe(2.9)
    assert wd.straggler_events == 1
