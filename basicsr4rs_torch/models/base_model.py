"""BaseModel (counterpart of ``basicsr4rs_tpu/models/base_model.py``;
reference: basicsr/models/base_model.py).

The device, network printing, ``.pth`` loading and saving with param keys
and strict key matching, validation dispatch, best-metric tracking,
optimizers, schedulers with linear warm-up, EMA, and the training state
(``.state`` files written by ``torch.save``).

Under a launcher (``opt['dist']``) each rank is one process on its card
(``cuda:<current device>``) and ``model_to_device`` sets a trained network
up for data parallelism: its norms take the global batch's statistics
(``parallel.sync_statistics``), and it is wrapped in
``DistributedDataParallel`` or, for a model class whose step does not fit
DDP's reducer (``WRAP_IN_DDP = False``), left bare with rank 0's weights,
its gradients averaged by ``average_gradients`` before each optimizer
step. Printing, saving, loading and the EMA go through the bare module, so
that no key gains ``module.``.

Under ``parallel: {spatial: N > 1}`` the ranks form a (data, spatial) grid
(``self.grid``): only a model class that declares a spatial route itself
(``SPATIAL_SHARDING``) builds, only networks that declare one are set up,
every trained network takes the ``average_gradients`` route over all the
ranks (no DDP: the halo exchanges of its backward must not interleave with
DDP's bucket hooks), and ``spatial_shard`` is what its forwards run under
(``parallel/halo.py``).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from os import path as osp
from typing import Any, Dict, List

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DataParallel, DistributedDataParallel

from ..parallel import opt_grid, replicate, require_spatial_route, sync_statistics
from ..parallel import average_gradients as _average_gradients
from ..parallel.halo import make_shard, spatial_scope
from ..utils.dist_util import broadcast_module, master_only
from ..utils.logger import get_root_logger
from . import lr_scheduler, optimizers

# buffers that BasicSR stores and the port computes (per input shape, or as
# constants: SpyNet's normalisation)
_COMPUTED_BUFFERS = ('relative_position_index', 'attn_mask', 'spynet.mean', 'spynet.std')


class BaseModel:

    # whether a trained network goes into DistributedDataParallel: a step of
    # one forward through the wrapper and one backward a network. A class
    # whose step is otherwise sets False and calls ``average_gradients``
    # before each optimizer step (parallel/mesh.py)
    WRAP_IN_DDP = True
    # whether this class (itself, not by inheritance: a subclass changes the
    # step or the validation) trains and validates on bands of rows under
    # parallel.spatial > 1
    SPATIAL_SHARDING = False

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt['is_train']
        world_size = opt.get('world_size', 1)
        if opt['num_gpu'] == 0:
            self.device = torch.device('cpu')
        elif torch.cuda.is_available():   # the card init_dist selected, or the first
            self.device = torch.device('cuda', torch.cuda.current_device())
        else:
            self.device = torch.device('cuda')
        self.grid = opt_grid(opt)   # under a launcher the axes must cover the ranks
        self.spatial_shard = None
        if self.grid.spatial > 1:
            if not type(self).__dict__.get('SPATIAL_SHARDING', False):
                raise NotImplementedError(
                    f'{type(self).__name__} has no spatial route (parallel.spatial > 1 splits '
                    'each image\'s rows over the ranks; see ROADMAP Queue 1 for the routes still '
                    'to port)')
            self.spatial_shard = make_shard(self.grid.data_rank, self.grid.spatial_rank,
                                            self.grid.spatial)
        self.best_metric_results: Dict[str, Any] = {}
        self.schedulers: List[Any] = []
        self.optimizers: List[torch.optim.Optimizer] = []
        self.log_dict: Dict[str, Any] = {}

    def feed_data(self, data):
        pass

    def optimize_parameters(self, current_iter):
        pass

    def test(self):
        pass

    def save(self, epoch, current_iter):
        pass

    def get_current_visuals(self):
        pass

    def validation(self, dataloader, current_iter, tb_logger, save_img: bool = False):
        """The ranks share the validation under a launcher with more than
        one rank (``dist_validation``); otherwise one process runs it all."""
        if self.opt.get('dist') and self.opt.get('world_size', 1) > 1:
            self.dist_validation(dataloader, current_iter, tb_logger, save_img)
        else:
            self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def dist_validation(self, dataloader, current_iter, tb_logger, save_img):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        raise NotImplementedError

    # ------------------------------------------------- best-metric tracking
    def _initialize_best_metric_results(self, dataset_name):
        if dataset_name in self.best_metric_results:
            return
        record = dict()
        for metric, content in self.opt['val']['metrics'].items():
            better = content.get('better', 'higher')
            init_val = float('-inf') if better == 'higher' else float('inf')
            record[metric] = dict(better=better, val=init_val, iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val, current_iter):
        record = self.best_metric_results[dataset_name][metric]
        if (val >= record['val']) if record['better'] == 'higher' else (val <= record['val']):
            record['val'] = val
            record['iter'] = current_iter

    # ------------------------------------------------- optimizers, schedulers
    def get_optimizer(self, optim_type: str, params, lr: float, **kwargs):
        """The optimizer of that name: ``torch.optim``'s, or ``Adafactor`` and
        ``Lamb`` of ``optimizers.py``. torch's ``Adam`` adds ``weight_decay``
        to the gradient (L2), which is what the JAX package's Adam composes
        by hand. As in the JAX package, Adafactor takes the rate alone, and
        Lamb ``betas``, ``eps`` and ``weight_decay``."""
        if optim_type == 'Adafactor':
            return optimizers.Adafactor(params, lr)
        if optim_type == 'Lamb':
            return optimizers.Lamb(params, lr, **{k: kwargs[k] for k in (
                'betas', 'eps', 'weight_decay') if k in kwargs})
        types = ('Adam', 'AdamW', 'Adamax', 'SGD', 'RMSprop', 'Adafactor', 'Lamb')
        if optim_type not in types:
            raise NotImplementedError(f'optimizer {optim_type} is not supported yet; '
                                      f'supported: {types}')
        return getattr(torch.optim, optim_type)(params, lr, **kwargs)

    def setup_schedulers(self):
        train_opt = self.opt['train']
        scheduler_opt = dict(train_opt.get('scheduler') or {'type': 'ConstantLR'})
        scheduler_type = scheduler_opt.pop('type')
        for optimizer in self.optimizers:
            if scheduler_type == 'MultiStepLR':
                scheduler = torch.optim.lr_scheduler.MultiStepLR(optimizer, **scheduler_opt)
            elif scheduler_type == 'MultiStepRestartLR':
                scheduler = lr_scheduler.MultiStepRestartLR(optimizer, **scheduler_opt)
            elif scheduler_type == 'CosineAnnealingRestartLR':
                scheduler = lr_scheduler.CosineAnnealingRestartLR(optimizer, **scheduler_opt)
            elif scheduler_type in ('ConstantLR', 'none', None):
                scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda _: 1.)
            else:
                raise NotImplementedError(f'Scheduler {scheduler_type} is not implemented yet.')
            self.schedulers.append(scheduler)

    def _get_init_lr(self):
        return [[group['initial_lr'] for group in optimizer.param_groups]
                for optimizer in self.optimizers]

    def update_learning_rate(self, current_iter: int, warmup_iter: int = -1):
        """Step the schedulers (from the second iteration on, so that each
        step follows an optimizer step), then overwrite the rates with the
        linear warm-up while ``current_iter < warmup_iter``."""
        if current_iter > 1:
            for optimizer, scheduler in zip(self.optimizers, self.schedulers):
                # a scheduler that derives the next rate from the group's current
                # one must find its own last value there, not the warm-up's
                for group, lr in zip(optimizer.param_groups, scheduler.get_last_lr()):
                    group['lr'] = lr
                scheduler.step()
        if current_iter < warmup_iter:
            for optimizer, init_lrs in zip(self.optimizers, self._get_init_lr()):
                warm = lr_scheduler.linear_warmup_lr(init_lrs, current_iter, warmup_iter)
                for group, lr in zip(optimizer.param_groups, warm):
                    group['lr'] = lr

    def get_current_learning_rate(self):
        return [group['lr'] for group in self.optimizers[0].param_groups]

    # ------------------------------------------------------------------- EMA
    def start_ema(self):
        """The weights ``net_g_ema`` starts from. A fine-tune or a fresh run
        starts it as a copy of ``net_g``, the weights loaded under
        ``param_key_g``, as the JAX package does: a checkpoint's own
        ``params_ema`` is not read then. A resumed run reads ``params_ema``
        of the resumed checkpoint, where the JAX package restores its EMA
        with the training state."""
        path_opt = self.opt['path']
        if path_opt.get('resume_state') and path_opt.get('pretrain_network_g') is not None:
            self.load_network(self.net_g_ema, path_opt['pretrain_network_g'],
                              path_opt.get('strict_load_g', True), 'params_ema')
        else:
            self.net_g_ema.load_state_dict(self.get_bare_model(self.net_g).state_dict())
        if self.data_parallel():   # rank 0's, whatever each rank loaded
            broadcast_module(self.net_g_ema)

    @torch.no_grad()
    def model_ema(self, decay: float = 0.999):
        """``net_g_ema = decay * net_g_ema + (1 - decay) * net_g``, parameters
        only, in place."""
        ema = list(self.net_g_ema.parameters())
        cur = list(self.get_bare_model(self.net_g).parameters())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, cur, alpha=1 - decay)

    def get_current_log(self):
        """The last step's losses as floats (this reads them off the device)."""
        return OrderedDict((k, float(v)) for k, v in self.log_dict.items())

    def reduce_loss_dict(self, loss_dict) -> OrderedDict:
        """The losses to log: detached device tensors, so that a training
        step never waits for the host; ``get_current_log`` turns them into
        floats when a line is printed. On several ranks, each is the mean
        over the ranks (one ``all_reduce``): with equal local batches, the
        global batch's mean, as the JAX step returns it."""
        world_size = self.opt.get('world_size', 1) if self.opt.get('dist') else 1
        if world_size == 1 or not loss_dict:
            return OrderedDict((k, v.detach()) for k, v in loss_dict.items())
        with torch.no_grad():
            values = torch.stack([v.detach().float() for v in loss_dict.values()])
            dist.all_reduce(values)
            values /= world_size
        return OrderedDict(zip(loss_dict, values.unbind()))

    # -------------------------------------------------------- data parallel
    def data_parallel(self) -> bool:
        """Whether this model trains on more than one rank."""
        return bool(self.is_train and self.opt.get('dist') and self.opt.get('world_size', 1) > 1)

    def wraps_in_ddp(self) -> bool:
        """Whether trained networks go into DDP: the class's ``WRAP_IN_DDP``,
        on the data axis alone (never under ``spatial > 1``)."""
        return self.WRAP_IN_DDP and self.grid.spatial == 1

    def spatial_scope(self):
        """The scope a forward on this rank's band runs in (``spatial_shard``;
        nothing on one band)."""
        return spatial_scope(self.spatial_shard)

    def model_to_device(self, net: nn.Module) -> nn.Module:
        """``net`` on the model's device; for training under a launcher, set
        up for data parallelism: on more than one rank its norms take the
        global batch's statistics (``sync_statistics``); wrapped in
        ``DistributedDataParallel`` with ``find_unused_parameters`` and
        ``broadcast_buffers`` of the config (BasicSR's keys), or, where the
        class does not wrap (``wraps_in_ddp``), rank 0's parameters and
        buffers broadcast to every rank. Under ``spatial > 1`` a network
        without a spatial route raises ``NotImplementedError`` first."""
        if self.grid.spatial > 1:
            require_spatial_route([net])
        net = net.to(self.device)
        if not (self.is_train and self.opt.get('dist')):
            return net
        if self.data_parallel():
            sync_statistics(net)
        if not self.wraps_in_ddp():
            broadcast_module(net)
            return net
        return replicate(net, self.device, self.opt.get('find_unused_parameters', False),
                         self.opt.get('broadcast_buffers', True))

    def average_gradients(self, *nets: nn.Module) -> None:
        """The global batch's gradients of ``nets``, before their optimizer
        steps: the mean over the ranks of each gradient where the model
        does not wrap in DDP (``parallel.average_gradients``); nothing
        under DDP, which averaged them in the backward, or on one rank."""
        if self.data_parallel() and not self.wraps_in_ddp():
            _average_gradients(*(self.get_bare_model(net) for net in nets))

    @staticmethod
    def get_bare_model(net: nn.Module) -> nn.Module:
        """The network inside a (Distributed)DataParallel wrapper, or ``net``."""
        if isinstance(net, (DataParallel, DistributedDataParallel)):
            return net.module
        return net

    # --------------------------------------------------------------- utils
    def print_network(self, net: nn.Module) -> None:
        net = self.get_bare_model(net)
        n = sum(p.numel() for p in net.parameters())
        get_root_logger().info(f'Network: {net.__class__.__name__}, with parameters: {n:,d}')

    def load_network(self, net: nn.Module, load_path: str, strict: bool = True,
                     param_key: str = 'params') -> None:
        """Load ``load_path`` (a ``.pth`` of ``{param_key: state_dict}`` or a
        bare state_dict) into ``net``. ``params_ema`` falls back to
        ``params``; ``module.`` prefixes and the buffers the port computes
        are dropped; ``strict`` makes any other key difference an error."""
        logger = get_root_logger()
        net = self.get_bare_model(net)
        ckpt = torch.load(load_path, map_location='cpu', weights_only=True)
        if param_key in ckpt:
            state_dict = ckpt[param_key]
        elif param_key == 'params_ema' and 'params' in ckpt:
            logger.info('Loading: params_ema does not exist, use params.')
            state_dict = ckpt['params']
        elif all(torch.is_tensor(v) for v in ckpt.values()):
            state_dict = ckpt
        else:
            raise KeyError(f'param key {param_key} not found in {load_path}; '
                           f'keys: {list(ckpt)[:8]}')
        logger.info(f'Loading {net.__class__.__name__} model from {load_path}, '
                    f'with param key: [{param_key}].')
        # the network's non-persistent buffers are constants the port makes
        # (TOFlow's normalisation, which BasicSR stores as ``mean``, ``std``)
        constants = {k for k, _ in net.named_buffers()} - set(net.state_dict())
        state_dict = OrderedDict(
            (k[len('module.'):] if k.startswith('module.') else k, v)
            for k, v in state_dict.items() if not k.endswith(_COMPUTED_BUFFERS))
        state_dict = OrderedDict((k, v) for k, v in state_dict.items() if k not in constants)
        net.load_state_dict(state_dict, strict=strict)

    # ----------------------------------------------------------- checkpoints
    @master_only
    def save_network(self, net, net_label: str, current_iter, param_key='params'):
        """Save ``models/net_<label>_<iter>.pth``: ``{param_key: state_dict}``
        on the CPU with BasicSR's key names. ``net`` and ``param_key`` may be
        lists of the same length (``params`` and ``params_ema``)."""
        if current_iter == -1:
            current_iter = 'latest'
        save_path = osp.join(self.opt['path']['models'], f'net_{net_label}_{current_iter}.pth')
        nets = net if isinstance(net, list) else [net]
        param_keys = param_key if isinstance(param_key, list) else [param_key]
        if len(nets) != len(param_keys):
            raise ValueError('The lengths of net and param_key should be the same.')
        save_dict = {}
        for net_, key in zip(nets, param_keys):
            save_dict[key] = OrderedDict(
                (k[len('module.'):] if k.startswith('module.') else k, v.cpu())
                for k, v in self.get_bare_model(net_).state_dict().items())
        _save_with_retry(save_dict, save_path)

    def save_training_state(self, epoch: int, current_iter: int):
        """Save ``training_states/<iter>.state``: epoch, iteration, and the
        state of every optimizer and scheduler. Every rank calls it: the
        model's own generators differ by rank, so on several ranks
        ``rank_states`` keeps each rank's ``extra_training_state`` (the top
        level keeps rank 0's); rank 0 writes the file."""
        if current_iter == -1:
            return
        extra = self.extra_training_state()
        world_size = self.opt.get('world_size', 1) if self.opt.get('dist') else 1
        rank_states = None
        if world_size > 1 and extra:
            rank_states = [None] * world_size
            dist.all_gather_object(rank_states, extra)
        if self.opt.get('rank', 0) != 0:
            return
        state = {'epoch': epoch, 'iter': current_iter,
                 'optimizers': [o.state_dict() for o in self.optimizers],
                 'schedulers': [s.state_dict() for s in self.schedulers]}
        state.update(extra)
        if rank_states is not None:
            state['rank_states'] = rank_states
        _save_with_retry(state, osp.join(self.opt['path']['training_states'],
                                         f'{current_iter}.state'))

    def extra_training_state(self) -> Dict[str, Any]:
        """What a model adds to the ``.state`` file (random generators)."""
        return {}

    def resume_training(self, resume_state):
        """Restore optimizers and schedulers; the networks come from the
        ``.pth`` of the same iteration (``utils.misc.check_resume``)."""
        optimizers, schedulers = resume_state['optimizers'], resume_state['schedulers']
        if len(optimizers) != len(self.optimizers) or len(schedulers) != len(self.schedulers):
            raise ValueError('Wrong lengths of optimizers or schedulers in the resume state')
        for optimizer, state in zip(self.optimizers, optimizers):
            optimizer.load_state_dict(state)
        for scheduler, state in zip(self.schedulers, schedulers):
            scheduler.load_state_dict(state)


def _save_with_retry(obj, save_path: str, retries: int = 3) -> None:
    """``torch.save`` through a temporary file, tried up to three times."""
    logger = get_root_logger()
    os.makedirs(osp.dirname(save_path), exist_ok=True)
    for remaining in range(retries - 1, -1, -1):
        try:
            torch.save(obj, save_path + '.tmp')
            os.replace(save_path + '.tmp', save_path)
            return
        except OSError as e:
            logger.warning(f'Save error: {e}, remaining retry times: {remaining}')
            time.sleep(1)
    raise IOError(f'Cannot save {save_path}.')
