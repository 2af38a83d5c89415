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
  losses and the bare UNet's and the EMA's parameters;
* ``{"kind": "model", "name": ..., "opt": {...}, "batches": path, "nets": [...],
  "control": bool, "draws": path}``: any model built from ``opt`` under the
  group (rank 0 alone loads the ``pretrain_network_*`` files: the others
  start from their own random weights, which rank 0's must replace), fed
  its rows of each global batch of ``batches`` (``rank_rows``), one
  ``optimize_parameters`` a batch; ``draws`` replays StyleGAN2's draws
  (``replayed_draws``). Rank 0 keeps the logged losses, the gradients each
  optimizer was handed, the bare ``nets``' state dicts and whether every
  rank holds the same;
* ``{"kind": "build", "name": ..., "opts": {label: opt}, "batches": path}``:
  each model built under the group from its own random weights and stepped
  once on its rows of its batch; rank 0 keeps how each trained network was
  set up, the losses, and whether the ranks hold the same weights;
* ``{"kind": "units", "name": ..., "inputs": path, "control": bool}``: the
  synced BatchNorm and the three global means of ``gan_loss`` on each
  rank's rows of ``inputs`` (``units_on_rows``); rank 0 keeps every rank's
  results;
* ``{"kind": "spatial", "name": ..., "spatial": n, "nets": [...], "model": {...},
  "control": bool}``: ``parallel: {spatial: n}`` (``run_spatial``). Each of
  ``nets`` (``{"label", "arch", "weights", "inputs", "float64"}``) runs on
  the rank's band of ``inputs``' x in eval and in train mode, its loss
  ``sum(out * v)`` over the band; rank 0 keeps the gathered output and input
  gradient and the parameter gradients summed over the ranks. ``model``
  (``{"opt", "batches", "val"}``) is built from ``opt`` under the group,
  stepped once a global batch of ``batches`` (``feed_data`` keeps the band)
  and validated on the items of ``val``; rank 0 keeps the losses, the
  parameters and the EMA, the validation's metrics and outputs, and which
  image ran on bands, then the same of a validation under ``val.quant_int8:
  static``. ``int8`` (``{"label", "arch", "weights", "inputs", "modes"}``):
  each network in float64 under ``quantized_inference`` on the rank's band
  of x, its scales dynamic or calibrated on the band (``spatial_int8``);
  ``pipelines`` (``{"label", "argv", "root"}``): ``basicsr4rs_torch.train``'s
  pipeline with that command line from ``root`` (``spatial_pipeline``). With ``control``
  the networks run on each band alone: no scope, so zero halos, a local
  roll and the band's own mask (``no_exchange``).

``control`` turns the synchronisation of statistics and means off (each
rank's own, ``no_stat_sync``), or with ``"grads"`` the gradient exchange
(``no_grad_exchange``), for the tests' controls; ``adam_eps`` sets Adam's
eps (``adam_eps``). Rank 0 writes
``<out_dir>/<name>.pt`` for each job. No JAX is imported here. The tests
start torchrun through ``torchrun`` below.
"""

import contextlib
import copy
import json
import os
import signal
import subprocess
import sys
from unittest import mock

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


def no_stat_sync():
    """Each rank's statistics and means its own: the differentiable sum over
    the ranks (``dist_util.all_reduce_sum``) is the identity, while the
    gradient exchange and the loss logging go on."""
    from basicsr4rs_torch.utils import dist_util
    return mock.patch.object(dist_util._SumOverRanks, 'apply', lambda t: t)


def rank_rows(n, rank, world_size):
    """The rows ``[start, stop)`` of ``n`` global rows that ``rank`` takes:
    ``n // world_size``, the first ``n % world_size`` ranks one more."""
    base, extra = divmod(n, world_size)
    start = rank * base + min(rank, extra)
    return start, start + base + int(rank < extra)


def take_rows(value, rank, world_size):
    """This rank's rows of a batch: of each tensor and list, nested dicts
    followed."""
    if isinstance(value, dict):
        return {k: take_rows(v, rank, world_size) for k, v in value.items()}
    if torch.is_tensor(value) or isinstance(value, list):
        start, stop = rank_rows(len(value), rank, world_size)
        return value[start:stop]
    return value


def replayed_draws(draws, rank, world_size):
    """``StyleGAN2Model.draw_step`` that hands out this rank's rows of the
    global draws of each step in turn (``draws``: one dict a step, the path
    batch's rows split as ``rank_rows``)."""
    steps = iter(draws)

    def draw_step(model, batch, regularize_g):
        step = next(steps)
        out = {k: [t[rank * batch:(rank + 1) * batch] for t in step[k]]
               for k in ('d_codes', 'd_noise', 'g_codes', 'g_noise')}
        if regularize_g:
            start, stop = rank_rows(len(step['path_proj']), rank, world_size)
            assert stop - start == model.path_rows(batch)
            out.update({k: [t[start:stop] for t in step[k]] for k in ('path_codes', 'path_noise')},
                       path_proj=step['path_proj'][start:stop])
        return out
    return draw_step


def step_model(model, batches, rank, world_size, draws=None):
    """One ``optimize_parameters`` on this rank's rows of each batch; the
    logged losses, and the gradients each optimizer was handed (by the
    network's parameter names) at each step."""
    from basicsr4rs_torch.models.stylegan2_model import StyleGAN2Model
    names = {}
    for label in ('net_g', 'net_d'):
        if hasattr(model, label):
            for name, p in model.get_bare_model(getattr(model, label)).named_parameters():
                names[p] = f'{label}.{name}'
    grads = []

    def keep(optimizer, args, kwargs):
        grads[-1].update({names[p]: p.grad.clone() for group in optimizer.param_groups
                          for p in group['params'] if p.grad is not None})

    for optimizer in model.optimizers:
        optimizer.register_step_pre_hook(keep)
    patch = (mock.patch.object(StyleGAN2Model, 'draw_step',
                               replayed_draws(draws, rank, world_size))
             if draws is not None else contextlib.nullcontext())
    losses = []
    with patch:
        for step, batch in enumerate(batches, 1):
            grads.append({})
            model.feed_data(take_rows(batch, rank, world_size))
            model.optimize_parameters(step)
            losses.append(model.get_current_log())
    return losses, grads


def model_result(model, nets, losses, grads):
    """What a run hands the test: losses, gradients, the bare ``nets``'
    state dicts and ``mean_path_length`` where the model keeps one."""
    states = {label: {k: v.detach().clone() for k, v in
                      model.get_bare_model(getattr(model, label)).state_dict().items()}
              for label in nets}
    extra = {'mean_path_length': float(model.mean_path_length)} if hasattr(
        model, 'mean_path_length') else {}
    return {'losses': losses, 'grads': grads, 'states': states, **extra}


def same_on_every_rank(tensors):
    """Whether every rank holds these tensors bit for bit."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().double().reshape(-1) for t in tensors])
    gathered = [torch.empty_like(flat) for _ in range(get_dist_info()[1])]
    dist.all_gather(gathered, flat)
    return all(torch.equal(g, gathered[0]) for g in gathered)


def no_grad_exchange():
    """Each rank's gradients its own: the flat exchange of the models that
    do not wrap in DDP does nothing."""
    from basicsr4rs_torch.models import base_model
    return mock.patch.object(base_model, '_average_gradients', lambda *nets: None)


def adam_eps(eps):
    """``BaseModel.get_optimizer`` with Adam's ``eps`` set (StyleGAN2 builds
    its Adam without one): at 1e-8 Adam's first step is the gradient's
    sign, which float32 noise flips near 0."""
    from basicsr4rs_torch.models.base_model import BaseModel
    get_optimizer = BaseModel.get_optimizer

    def patched(self, optim_type, params, lr, **kwargs):
        return get_optimizer(self, optim_type, params, lr, eps=eps, **kwargs)
    return mock.patch.object(BaseModel, 'get_optimizer', patched)


def controls(job):
    """The patches of a job: ``control`` 'grads' turns the gradient exchange
    off, any other true value the statistics' synchronisation; ``adam_eps``
    sets Adam's eps."""
    stack = contextlib.ExitStack()
    control = job.get('control')
    if control == 'grads':
        stack.enter_context(no_grad_exchange())
    elif control:
        stack.enter_context(no_stat_sync())
    if job.get('adam_eps'):
        stack.enter_context(adam_eps(job['adam_eps']))
    return stack


def one_process(opt, batches, nets, draws=None, eps=None):
    """The same model in this process at the global batch (no group): what
    ``run_model`` hands back, for the tests' side. At one torch thread, as
    the ranks run: a convolution's bias gradient over a 256x256 map sums
    otherwise in another order, which moves it by 1e-3 of the network's
    largest gradient."""
    from basicsr4rs_torch.models import build_model
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with controls({'adam_eps': eps}):
            model = build_model(dict(copy.deepcopy(opt), dist=False, rank=0, world_size=1))
        losses, grads = step_model(model, batches, 0, 1, draws)
    finally:
        torch.set_num_threads(threads)
    return model_result(model, nets, losses, grads)


def states_close(got, want, atol, rtol):
    """Whether every tensor of the runs' state dicts agrees within
    ``atol + rtol * |want|`` (integer buffers exactly)."""
    for label, state in want.items():
        for key, value in state.items():
            mine = got[label][key]
            if not value.is_floating_point():
                if not torch.equal(mine, value):
                    return False
            elif not torch.allclose(mine, value, atol=atol, rtol=rtol):
                return False
    return True


def run_model(job):
    from basicsr4rs_torch.models import build_model
    rank, world_size = get_dist_info()
    opt = copy.deepcopy(job['opt'])
    opt.update(dist=True, rank=rank, world_size=world_size)
    if rank:
        for key in [k for k in opt['path'] if k.startswith('pretrain_network_')
                    and k != 'pretrain_network_ae']:
            opt['path'][key] = None
    torch.manual_seed(100 + rank)
    draws = torch.load(job['draws'], weights_only=True) if job.get('draws') else None
    with controls(job):
        model = build_model(opt)
        losses, grads = step_model(model, torch.load(job['batches'], weights_only=False), rank,
                                   world_size, draws)
    result = model_result(model, job['nets'], losses, grads)
    result['same_on_ranks'] = same_on_every_rank(
        [t for state in result['states'].values() for t in state.values()])
    return result


def run_build(job):
    """Each model of ``opts`` built under the group, every rank from its own
    random weights, and stepped once on its rows of ``batches[label]``
    where given: the type of each trained network, whether its norms take
    the global statistics, the logged losses, and whether every rank then
    holds rank 0's parameters and buffers."""
    from basicsr4rs_torch.models import build_model
    rank, world_size = get_dist_info()
    batches = torch.load(job['batches'], weights_only=False) if job.get('batches') else {}
    out = {}
    for label, opt in job['opts'].items():
        torch.manual_seed(100 + rank)
        model = build_model(dict(copy.deepcopy(opt), dist=True, rank=rank, world_size=world_size))
        nets = {name: getattr(model, name) for name in ('net_g', 'net_d') if hasattr(model, name)}
        losses = None
        if label in batches:   # one step on the rank's rows
            model.feed_data(take_rows(batches[label], rank, world_size))
            model.optimize_parameters(1)
            losses = model.get_current_log()
        states = [model.get_bare_model(net).state_dict() for net in nets.values()]
        if getattr(model, 'net_g_ema', None) is not None:
            states.append(model.net_g_ema.state_dict())
        out[label] = {
            'losses': losses, 'model': type(model).__name__,
            'nets': {name: type(net).__name__ for name, net in nets.items()},
            'synced': {name: [m.sync_ranks for m in model.get_bare_model(net).modules()
                              if hasattr(m, 'sync_ranks')] for name, net in nets.items()},
            'same_on_ranks': same_on_every_rank([t for st in states for t in st.values()])}
    return out


def units_on_rows(inputs, rank, world_size):
    """The synced ``BatchNorm2d`` (a train pass, then one under
    ``frozen_batch_stats``), ``r1_penalty``, ``g_path_regularize`` and
    ``gradient_penalty_loss`` on this rank's rows of ``inputs``: outputs,
    input and parameter gradients, running statistics. Each loss of a rank
    is the sum over its own rows, so that the ranks' losses add up to the
    whole batch's."""
    from basicsr4rs_torch.archs.arch_util import BatchNorm2d, frozen_batch_stats
    from basicsr4rs_torch.losses import gan_loss
    from basicsr4rs_torch.parallel import sync_statistics
    rows = {k: take_rows(v, rank, world_size) if k in inputs['split'] else v
            for k, v in inputs.items() if k != 'split'}
    out = {}
    bn = BatchNorm2d(rows['bn_x'].shape[1])
    with torch.no_grad():
        bn.weight.copy_(rows['bn_weight'])
        bn.bias.copy_(rows['bn_bias'])
    sync_statistics(bn)
    x = rows['bn_x'].clone().requires_grad_(True)
    y = bn(x)
    (y * rows['bn_w']).sum().backward()
    with frozen_batch_stats(bn):
        frozen = bn(rows['bn_x']).detach()
    out['bn'] = {'y': y.detach(), 'frozen_y': frozen, 'x_grad': x.grad,
                 'weight_grad': bn.weight.grad, 'bias_grad': bn.bias.grad,
                 'running_mean': bn.running_mean.clone(), 'running_var': bn.running_var.clone()}

    def conv_d(w):
        return lambda img: torch.tanh(torch.nn.functional.conv2d(img, w, padding=1)).mean(
            dim=(1, 2, 3)) * 3.

    w = rows['d_weight'].clone().requires_grad_(True)
    r1 = gan_loss.r1_penalty(conv_d(w), rows['real'])
    r1.backward()
    out['r1'] = {'value': r1.detach(), 'grad': w.grad}
    w = rows['d_weight'].clone().requires_grad_(True)
    gp = gan_loss.gradient_penalty_loss(conv_d(w), rows['real'], rows['fake'], rows['alpha'],
                                        rows['gp_weight'])
    gp.backward()
    out['gp'] = {'value': gp.detach(), 'grad': w.grad}
    a = rows['path_a'].clone().requires_grad_(True)
    n, c, h, wd = rows['path_noise'].shape

    def fake(lat):
        return torch.tanh(torch.einsum('nlf,fk->nk', lat, a)).reshape(len(lat), h, wd, c).permute(
            0, 3, 1, 2)

    pen, lengths, mean = gan_loss.g_path_regularize(fake, rows['latents'], 0.5,
                                                    rows['path_noise'])
    pen.backward()
    out['path'] = {'value': pen.detach(), 'lengths': lengths, 'mean': mean, 'grad': a.grad}
    return out


def run_units(job):
    import torch.distributed as dist
    rank, world_size = get_dist_info()
    inputs = torch.load(job['inputs'], weights_only=False)
    with no_stat_sync() if job.get('control') else contextlib.nullcontext():
        mine = units_on_rows(inputs, rank, world_size)
    every = [None] * world_size
    dist.all_gather_object(every, mine)
    return every


def no_exchange():
    """Each band alone: the models' spatial scope is no scope."""
    from basicsr4rs_torch.models import base_model
    return mock.patch.object(base_model.BaseModel, 'spatial_scope',
                             lambda self: contextlib.nullcontext())


def spatial_net(case, shard, control):
    """One network of a ``spatial`` job in eval and in train mode on this
    rank's band: the gathered output and input gradient, the parameter
    gradients summed over the ranks."""
    import torch.distributed as dist
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.parallel import gather_rows, spatial_scope
    from basicsr4rs_torch.parallel.halo import band_of
    net = build_network(dict(case['arch']))
    if case.get('float64'):
        net.double()
    net.load_state_dict(torch.load(case['weights'], weights_only=True))
    inputs = torch.load(case['inputs'], weights_only=True)
    out = {}
    for mode in ('eval', 'train'):
        net.train(mode == 'train')
        net.zero_grad(set_to_none=True)
        x = band_of(inputs['x'], shard).clone().requires_grad_(True)
        with contextlib.nullcontext() if control else spatial_scope(shard):
            y = net(x)
        (y * band_of(inputs['v'], shard)).sum().backward()
        grads = {k: p.grad.clone() for k, p in net.named_parameters()}
        for g in grads.values():
            dist.all_reduce(g)
        out[mode] = {'out': gather_rows(y.detach(), shard), 'dx': gather_rows(x.grad, shard),
                     'grads': grads}
    return out


class ItemLoader:
    """A validation loader of given items (``lq``, ``gt``, ``lq_path``) as
    the spatial validation reads it: its ``dataset`` indexes them."""

    def __init__(self, items, name):
        self.items, self.opt = items, {'name': name}
        self.dataset = self

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def spatial_model(case, rank, world_size):
    """The ``model`` of a ``spatial`` job: steps on the global batches, then
    a validation (the images strided over the data ranks, each shared by its
    spatial group)."""
    from basicsr4rs_torch.models import build_model
    opt = copy.deepcopy(case['opt'])
    opt.update(dist=True, rank=rank, world_size=world_size)
    if rank:
        opt['path']['pretrain_network_g'] = None
    torch.manual_seed(100 + rank)
    model = build_model(opt)
    losses = []
    for step, batch in enumerate(torch.load(case['batches'], weights_only=True), 1):
        model.feed_data(batch)
        model.optimize_parameters(step)
        losses.append(model.get_current_log())
    lq_rows = model.lq.shape[2]
    outputs, on_bands = [], []
    test = type(model).test

    def kept(self):
        on_bands.append(self._eval_on_bands(self.lq))
        test(self)
        outputs.append(self.output.clone())

    val = ItemLoader(torch.load(case['val'], weights_only=False), 'spatial_val')
    with mock.patch.object(type(model), 'test', kept):
        model.validation(val, len(losses), None, False)
        metrics = dict(model.metric_results)
        float_runs = len(outputs)
        model.opt['val']['quant_int8'] = 'static'
        model.validation(val, len(losses), None, False)
    bare = model.get_bare_model(model.net_g)
    params = {k: v.detach().clone() for k, v in bare.state_dict().items()}
    return {'losses': losses, 'net': type(model.net_g).__name__, 'params': params,
            'ema': {k: v.detach().clone() for k, v in model.net_g_ema.state_dict().items()},
            'metrics': metrics, 'outputs': outputs[:float_runs],
            'on_bands': on_bands[:float_runs], 'int8_outputs': outputs[float_runs:],
            'int8_on_bands': on_bands[float_runs:], 'lq_rows': lq_rows,
            'same_on_ranks': same_on_every_rank(list(params.values()))}


def spatial_int8(case, shard):
    """One network of a ``spatial`` job's ``int8`` in float64 under
    ``quantized_inference`` on this rank's band of x, for each of ``modes``:
    dynamic scales, or static ones calibrated on the band; the gathered
    output."""
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.ops.quant import calibrate_act_scales, quantized_inference
    from basicsr4rs_torch.parallel import gather_rows, spatial_scope
    from basicsr4rs_torch.parallel.halo import band_of
    net = build_network(dict(case['arch'])).double().eval()
    net.load_state_dict(torch.load(case['weights'], weights_only=True))
    x = band_of(torch.load(case['inputs'], weights_only=True)['x'], shard)
    out = {}
    with torch.no_grad(), spatial_scope(shard):
        for mode in case['modes']:
            scales = calibrate_act_scales(net, net, [x]) if mode == 'static' else None
            with quantized_inference(net, act_scales=scales):
                out[mode] = gather_rows(net(x), shard)
    return out


def spatial_pipeline(argv, root):
    """``basicsr4rs_torch.train``'s pipeline (``SwinIRModel``) with the
    command line ``argv`` from ``root``: each step's logged loss and LQ
    rows, and each validation image's output and whether it ran on bands;
    the validation's metrics."""
    from basicsr4rs_torch import train
    from basicsr4rs_torch.models.swinir_model import SwinIRModel
    steps, outputs, on_bands = [], [], []
    step, test = SwinIRModel.optimize_parameters, SwinIRModel.test

    def logged_step(self, current_iter):
        step(self, current_iter)
        steps.append({'l_pix': float(self.log_dict['l_pix']), 'lq_rows': self.lq.shape[2]})

    def kept(self):
        on_bands.append(self._eval_on_bands(self.lq))
        test(self)
        outputs.append(self.output.clone())

    saved = sys.argv
    sys.argv = ['train.py', *argv]
    try:
        with mock.patch.object(SwinIRModel, 'optimize_parameters', logged_step), \
                mock.patch.object(SwinIRModel, 'test', kept):
            model = train.train_pipeline(root)
    finally:
        sys.argv = saved
    return {'steps': steps, 'outputs': outputs, 'on_bands': on_bands,
            'metrics': dict(model.metric_results), 'net': type(model.net_g).__name__}


def run_spatial(job):
    from basicsr4rs_torch.parallel.halo import make_shard
    rank, world_size = get_dist_info()
    spatial = job['spatial']
    shard = make_shard(rank // spatial, rank % spatial, spatial)
    out = {'nets': {}}
    for case in job.get('nets', []):
        out['nets'][case['label']] = spatial_net(case, shard, job.get('control'))
    if job.get('model'):
        with no_exchange() if job.get('control') else contextlib.nullcontext():
            out['model'] = spatial_model(job['model'], rank, world_size)
    out['int8'] = {case['label']: spatial_int8(case, shard) for case in job.get('int8', [])}
    out['pipelines'] = {case['label']: spatial_pipeline(case['argv'], case['root'])
                        for case in job.get('pipelines', [])}
    return out


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
                      'collectives': run_collectives, 'model': run_model, 'build': run_build,
                      'units': run_units, 'spatial': run_spatial}[job['kind']](job)
            if get_dist_info()[0] == 0:
                torch.save(result, os.path.join(out_dir, f'{job["name"]}.pt'))
            barrier()
    finally:
        close_dist()


if __name__ == '__main__':
    main()
