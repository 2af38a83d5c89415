"""Test pipeline (counterpart of ``basicsr4rs_tpu/test.py``; reference:
basicsr/test.py).

Run: ``python -m basicsr4rs_torch.test -opt options/test/....yml``; on N
ranks (``python -m torch.distributed.run --standalone --nproc_per_node N -m
basicsr4rs_torch.test -opt <yml> --launcher pytorch``) the models share the
evaluation out through their ``dist_validation``: the video models stride the
items over the ranks and merge the metrics, the image models evaluate on
rank 0.
"""

from __future__ import annotations

import logging
from os import path as osp

from basicsr4rs_torch.data import build_dataloader, build_dataset
from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.utils import (dict2str, get_env_info, get_root_logger, get_time_str,
                                    make_exp_dirs)
from basicsr4rs_torch.utils.dist_util import barrier, close_dist
from basicsr4rs_torch.utils.options import parse_options


def test_pipeline(root_path):
    opt, _ = parse_options(root_path, is_train=False)
    opt['root_path'] = root_path

    make_exp_dirs(opt)
    barrier()   # rank 0 made the folders
    log_file = osp.join(opt['path']['log'], f"test_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        test_set = build_dataset(dataset_opt)
        test_loader = build_dataloader(test_set, dataset_opt, num_gpu=opt['num_gpu'],
                                       dist=opt['dist'])
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")
        test_loaders.append(test_loader)

    model = build_model(opt)

    for test_loader in test_loaders:
        logger.info(f"Testing {test_loader.dataset.opt['name']}...")
        model.validation(test_loader, current_iter=opt['name'], tb_logger=None,
                         save_img=opt['val'].get('save_img', False))
    return model


def main():
    root_path = osp.abspath(osp.join(__file__, osp.pardir, osp.pardir))
    try:
        test_pipeline(root_path)
    finally:
        close_dist()


if __name__ == '__main__':
    main()
