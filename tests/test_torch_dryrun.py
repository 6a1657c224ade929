"""The port's dry run (``r3det_tpu_torch/dryrun.py``) on the CPU.

- ``dryrun_multichip(2)`` passes in a fresh process that sees no card
  (``CUDA_VISIBLE_DEVICES=''``), as ``tests/test_graft_entry.py`` runs the
  JAX function;
- with ``parallel/dist.py::all_reduce_grads`` made a no-op in every
  process of the run (a ``sitecustomize`` on ``PYTHONPATH``: each rank
  then steps on its own image's gradient), it fails: the ranks' replica
  check (``dist.check_replicas``) finds their parameters apart, or the
  comparison with the single process does. A broken collective cannot
  pass. The two runs go side by side;
- ``entry(device='cpu')`` returns finite sums of every head output: the
  base head's 5 + 5 level maps, the refine stage's 5 + 5 and its 5 levels
  of rois.
"""
import os
import subprocess
import sys

import torch

from r3det_tpu_torch.dryrun import entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600

NO_OP_ALL_REDUCE = '''
import torch
from r3det_tpu_torch.parallel import dist


def all_reduce_grads(grads, params, group=None):
    """Each rank keeps its own gradients: the collective is broken."""
    return [torch.zeros(p.shape) if g is None else g.detach().float()
            for g, p in zip(grads, params)]


dist.all_reduce_grads = all_reduce_grads
'''


def _dryrun(env_path=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (env_path, ROOT, os.environ.get('PYTHONPATH')) if p)
    return subprocess.Popen(
        [sys.executable, '-c', 'from r3det_tpu_torch.dryrun import '
         'dryrun_multichip; dryrun_multichip(2)'],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_dryrun_multichip_passes_and_a_broken_all_reduce_fails(tmp_path):
    (tmp_path / 'sitecustomize.py').write_text(NO_OP_ALL_REDUCE)
    good, broken = _dryrun(), _dryrun(str(tmp_path))
    try:
        out, err = good.communicate(timeout=TIMEOUT)
        b_out, b_err = broken.communicate(timeout=TIMEOUT)
    finally:
        for p in (good, broken):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert good.returncode == 0, f'{out}\n{err}'
    assert 'dryrun_multichip(2) OK' in out
    assert broken.returncode != 0, b_out
    assert ('hold another state than rank 0' in b_err
            or 'the gradient all-reduce is broken' in b_err), b_err


def test_entry_on_the_cpu_gives_finite_sums():
    fn, (images,) = entry(device='cpu')
    assert tuple(images.shape) == (1, 512, 512, 3)
    assert images.device.type == 'cpu'
    sums = fn(images)
    assert len(sums) == 25
    assert all(s.dim() == 0 and bool(torch.isfinite(s)) for s in sums)
