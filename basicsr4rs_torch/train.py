"""Training pipeline (counterpart of ``basicsr4rs_tpu/train.py``; reference:
basicsr/train.py).

Parse the options, resume if asked, build the loggers, the train and
validation loaders and the model, then loop: learning-rate update, one
optimization step, logging, checkpoints and validation at their intervals.

Run: ``python -m basicsr4rs_torch.train -opt options/train/....yml``; on N
cards, one rank each: ``python -m torch.distributed.run --standalone
--nproc_per_node N -m basicsr4rs_torch.train -opt <yml> --launcher pytorch``.
Every rank takes the same steps, checkpoints and validations; rank 0 alone
makes the folders, copies the option file and writes the logs and files.
With ``parallel: {spatial: N}`` the ranks form a (data, spatial) grid: the
N ranks of a spatial group load the same items (the sampler and the crops
by data rank) and each trains on its band of their rows.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import time
from os import path as osp

import torch

from basicsr4rs_torch.data import (CPUPrefetcher, CUDAPrefetcher, EnlargedSampler,
                                   build_dataloader, build_dataset)
from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.parallel import opt_grid
from basicsr4rs_torch.utils import (AvgTimer, MessageLogger, check_resume, copy_opt_file, dict2str,
                                    find_latest_checkpoint_iter, get_env_info, get_root_logger,
                                    get_time_str, init_tb_logger, init_wandb_logger, make_exp_dirs)
from basicsr4rs_torch.utils.dist_util import barrier, close_dist
from basicsr4rs_torch.utils.options import parse_options


def init_tb_loggers(opt):
    wandb_opt = opt['logger'].get('wandb')
    if wandb_opt is not None and wandb_opt.get('project') is not None:
        if opt['logger'].get('use_tb_logger') is not True:
            raise ValueError('should turn on tensorboard when using wandb')
        init_wandb_logger(opt)
    tb_logger = None
    if opt['logger'].get('use_tb_logger') and 'debug' not in opt['name']:
        tb_logger = init_tb_logger(log_dir=osp.join(opt['root_path'], 'tb_logger', opt['name']))
    return tb_logger


def create_train_val_dataloader(opt, logger):
    train_loader, train_sampler, val_loaders = None, None, []
    total_epochs = total_iters = 0
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            dataset_enlarge_ratio = dataset_opt.get('dataset_enlarge_ratio', 1)
            # each data rank crops and flips from its own seed and takes its
            # own stride of the items; the ranks of a spatial group load the
            # same rows (each then keeps its band)
            grid = opt_grid(opt)
            dataset_opt.setdefault('manual_seed', opt['manual_seed'] + grid.data_rank)
            if grid.spatial > 1 and dataset_opt.get('num_worker_per_gpu', 0) > 0:
                # the dataset draws from one generator, and worker threads
                # would take its draws in an order of their own on each rank
                logger.warning('parallel.spatial > 1: the train loader runs without worker '
                               'threads, so that the ranks of a spatial group draw the same '
                               'crops and flips')
                dataset_opt['num_worker_per_gpu'] = 0
            train_set = build_dataset(dataset_opt)
            train_sampler = EnlargedSampler(len(train_set), grid.data, grid.data_rank,
                                            dataset_enlarge_ratio)
            train_loader = build_dataloader(train_set, dataset_opt, num_gpu=opt['num_gpu'],
                                            dist=opt['dist'], sampler=train_sampler,
                                            seed=opt['manual_seed'] + grid.data_rank)
            global_batch = train_loader.batch_size * grid.data
            if len(train_loader) == 0:
                raise ValueError(
                    f'Train dataloader is empty: {len(train_set)} images x enlarge '
                    f'{dataset_enlarge_ratio} < global batch {global_batch} '
                    '(batch_size_per_gpu x num_gpu x data ranks) with drop_last. Increase '
                    'dataset_enlarge_ratio or reduce the batch size.')
            num_iter_per_epoch = math.ceil(
                len(train_set) * dataset_enlarge_ratio / global_batch)
            total_iters = int(opt['train']['total_iter'])
            total_epochs = math.ceil(total_iters / num_iter_per_epoch)
            logger.info('Training statistics:'
                        f'\n\tNumber of train images: {len(train_set)}'
                        f'\n\tDataset enlarge ratio: {dataset_enlarge_ratio}'
                        f'\n\tBatch size per gpu: {dataset_opt["batch_size_per_gpu"]}'
                        f'\n\tWorld size (process count): {opt["world_size"]}'
                        f'\n\tParallel axes (data, spatial): {(grid.data, grid.spatial)}'
                        f'\n\tRequire iter number per epoch: {num_iter_per_epoch}'
                        f'\n\tTotal epochs: {total_epochs}; iters: {total_iters}.')
        elif phase.split('_')[0] == 'val':
            val_set = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt, num_gpu=opt['num_gpu'],
                                                dist=opt['dist']))
            logger.info(f'Number of val images/folders in {dataset_opt["name"]}: {len(val_set)}')
        else:
            raise ValueError(f'Dataset phase {phase} is not recognized.')
    return train_loader, train_sampler, val_loaders, total_epochs, total_iters


def load_resume_state(opt):
    """The ``.state`` to resume from: the latest under the experiment's
    ``training_states/`` with ``--auto_resume``, else ``path: resume_state``,
    else None."""
    resume_state_path = None
    if opt['auto_resume']:
        state_dir = osp.join(opt['path']['experiments_root'], 'training_states')
        latest = find_latest_checkpoint_iter(state_dir)
        if latest is not None:
            resume_state_path = osp.join(state_dir, f'{latest}.state')
            opt['path']['resume_state'] = resume_state_path
    elif opt['path'].get('resume_state'):
        resume_state_path = opt['path']['resume_state']

    if resume_state_path is None:
        return None
    resume_state = torch.load(resume_state_path, map_location='cpu', weights_only=True)
    # each rank's own generators, where the run that saved it had as many ranks
    rank_states = resume_state.pop('rank_states', None)
    if rank_states is not None and len(rank_states) == opt['world_size']:
        resume_state.update(rank_states[opt['rank']])
    check_resume(opt, resume_state['iter'])
    return resume_state


def train_pipeline(root_path):
    opt, args = parse_options(root_path, is_train=True)
    opt['root_path'] = root_path

    resume_state = load_resume_state(opt)
    if resume_state is None:
        make_exp_dirs(opt)
        if opt['logger'].get('use_tb_logger') and 'debug' not in opt['name'] and opt['rank'] == 0:
            os.makedirs(osp.join(root_path, 'tb_logger', opt['name']), exist_ok=True)
    barrier()   # no rank reads the experiment's folder before rank 0 made it

    copy_opt_file(args.opt, opt['path']['experiments_root'])

    log_file = osp.join(opt['path']['log'], f"train_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = init_tb_loggers(opt)

    result = create_train_val_dataloader(opt, logger)
    train_loader, train_sampler, val_loaders, total_epochs, total_iters = result

    model = build_model(opt)
    if resume_state is not None:
        model.resume_training(resume_state)
        logger.info(f"Resuming training from epoch: {resume_state['epoch']}, "
                    f"iter: {resume_state['iter']}.")
        start_epoch, current_iter = resume_state['epoch'], resume_state['iter']
    else:
        start_epoch, current_iter = 0, 0

    msg_logger = MessageLogger(opt, current_iter, tb_logger)

    prefetch_mode = opt['datasets']['train'].get('prefetch_mode')
    if prefetch_mode is None or prefetch_mode == 'cpu':
        prefetcher = CPUPrefetcher(train_loader)
    elif prefetch_mode == 'cuda':
        prefetcher = CUDAPrefetcher(train_loader, model.device)
        logger.info(f'Use {prefetch_mode} prefetch dataloader')
    else:
        raise ValueError(f"Wrong prefetch_mode {prefetch_mode}. Supported ones are: None, "
                         "'cuda', 'cpu'.")

    logger.info(f'Start training from epoch: {start_epoch}, iter: {current_iter}')
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    start_time = time.time()

    epoch = start_epoch
    while current_iter <= total_iters:
        train_sampler.set_epoch(epoch)
        prefetcher.reset()
        train_data = prefetcher.next()

        while train_data is not None:
            data_timer.record()

            current_iter += 1
            if current_iter > total_iters:
                break
            model.update_learning_rate(current_iter,
                                       warmup_iter=opt['train'].get('warmup_iter', -1))
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
            iter_timer.record()
            if current_iter == 1:
                # reset start time in msg_logger for more accurate eta_time
                msg_logger.reset_start_time()

            if current_iter % opt['logger']['print_freq'] == 0:
                log_vars = {'epoch': epoch, 'iter': current_iter}
                log_vars.update({'lrs': model.get_current_learning_rate()})
                log_vars.update({'time': iter_timer.get_avg_time(),
                                 'data_time': data_timer.get_avg_time()})
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)

            if current_iter % opt['logger']['save_checkpoint_freq'] == 0:
                logger.info('Saving models and training states.')
                model.save(epoch, current_iter)

            if (opt.get('val') is not None and opt['val'].get('val_freq')
                    and current_iter % opt['val']['val_freq'] == 0):
                for val_loader in val_loaders:
                    model.validation(val_loader, current_iter, tb_logger,
                                     opt['val'].get('save_img', False))

            data_timer.start()
            iter_timer.start()
            train_data = prefetcher.next()
        epoch += 1

    consumed_time = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f'End of training. Time consumed: {consumed_time}')
    logger.info('Save the latest model.')
    model.save(epoch=-1, current_iter=-1)
    if opt.get('val') is not None:
        for val_loader in val_loaders:
            model.validation(val_loader, current_iter, tb_logger,
                             opt['val'].get('save_img', False))
    if tb_logger:
        tb_logger.close()
    return model


def main():
    root_path = osp.abspath(osp.join(__file__, osp.pardir, osp.pardir))
    try:
        train_pipeline(root_path)
    finally:
        close_dist()


if __name__ == '__main__':
    main()
