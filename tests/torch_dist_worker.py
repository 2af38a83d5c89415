"""One rank of the port's data-parallel tests, started by torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/torch_dist_worker.py <out_dir> <job.json>

``job.json`` lists what every rank runs, in order, on gloo and the CPU:

* ``{"kind": "test", "name": ..., "argv": [...]}``: ``basicsr4rs_torch.test``'s
  ``test_pipeline`` with that command line (``--launcher pytorch`` in it);
  rank 0 keeps the model's per-folder metric rows and averages;
* ``{"kind": "resshift", "name": ..., "opt": {...}, "ae": path, "batches": npz,
  "steps": n}``: ``ResShiftModel`` built from ``opt`` under the group, each
  rank fed its half of every global batch of ``batches`` (``tt`` and
  ``noise`` in them), ``steps`` optimisation steps; rank 0 keeps the logged
  losses and the bare UNet's and the EMA's parameters.

Rank 0 writes ``<out_dir>/<name>.pt`` for each job. No JAX is imported here.
The tests start torchrun through ``torchrun`` below.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, REPO)

from basicsr4rs_torch.utils.dist_util import barrier, close_dist, get_dist_info, init_dist  # noqa


def torchrun(nproc, *args, timeout=240):
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc
    args`` from the repo root, in a session of its own; its output. Fails
    when any rank exits non-zero (torchrun then stops the others and returns
    non-zero), and kills the launcher and every rank when they are not done
    within ``timeout`` seconds."""
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, '-m', 'torch.distributed.run', '--standalone',
                             '--nproc_per_node', str(nproc), *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f'torchrun did not end within {timeout} s\n{out[-4000:]}{err[-6000:]}')
    assert proc.returncode == 0, out[-4000:] + err[-6000:]
    return out + err


def run_test(job):
    from basicsr4rs_torch.test import test_pipeline
    argv = sys.argv
    sys.argv = ['test.py', *job['argv']]
    try:
        model = test_pipeline(REPO)
    finally:
        sys.argv = argv
    return {'per_folder': {k: np.asarray(v) for k, v in model.metric_results_per_folder.items()},
            'metrics': dict(model.metric_results)}


def run_resshift(job):
    from basicsr4rs_torch.models import build_model
    rank, world_size = get_dist_info()
    opt = dict(job['opt'], dist=True, rank=rank, world_size=world_size)
    model = build_model(opt)
    model.first_stage.load_state_dict(torch.load(job['ae'], weights_only=True))
    batches = np.load(job['batches'])
    losses = []
    for step in range(job['steps']):
        batch = {k: torch.from_numpy(batches[f'{k}{step}']) for k in ('lq', 'gt', 'tt', 'noise')}
        local = len(batch['lq']) // world_size
        model.feed_data({k: v[rank * local:(rank + 1) * local] for k, v in batch.items()})
        model.optimize_parameters(step + 1)
        losses.append(model.get_current_log()['loss'])
    net = model.get_bare_model(model.net_g)
    return {'losses': losses, 'wrapped': type(model.net_g).__name__,
            'first_stage': type(model.first_stage).__name__,
            'params': {k: v.detach().clone() for k, v in net.state_dict().items()},
            'ema': {k: v.detach().clone() for k, v in model.net_g_ema.state_dict().items()}}


def run_collectives(job):
    from basicsr4rs_torch.models.base_model import BaseModel
    from basicsr4rs_torch.utils.dist_util import get_device_info, sum_across_processes
    rank, world_size = get_dist_info()
    rows = np.zeros((6, 2), np.float32)
    rows[rank::world_size] = np.arange(12, dtype=np.float32).reshape(6, 2)[rank::world_size]
    model = BaseModel({'is_train': True, 'num_gpu': 0, 'dist': True, 'rank': rank,
                       'world_size': world_size})
    losses = model.reduce_loss_dict({'l_a': torch.tensor(rank + 1.),
                                     'l_b': torch.tensor(10. * rank)})
    return {'merged': sum_across_processes(rows), 'device_info': get_device_info(),
            'losses': {k: float(v) for k, v in losses.items()}}


def main():
    out_dir, job_file = sys.argv[1:3]
    torch.set_num_threads(1)
    init_dist('pytorch', 'gloo', use_cuda=False)
    try:
        with open(job_file) as f:
            jobs = json.load(f)
        for job in jobs:
            result = {'test': run_test, 'resshift': run_resshift,
                      'collectives': run_collectives}[job['kind']](job)
            if get_dist_info()[0] == 0:
                torch.save(result, os.path.join(out_dir, f'{job["name"]}.pt'))
            barrier()
    finally:
        close_dist()


if __name__ == '__main__':
    main()
