"""Crop large images into overlapping sub-images for faster training IO
(counterpart of ``scripts/data_preparation/extract_subimages.py``;
reference: scripts/data_preparation/extract_subimages.py).

    python -m basicsr4rs_torch.scripts.data_preparation.extract_subimages \
        --input datasets/DIV2K/DIV2K_train_HR --output datasets/DIV2K/DIV2K_train_HR_sub \
        [--crop-size 480] [--step 240] [--thresh-size 0] [--n-thread 20]

Each image ``name.ext`` gives ``name_s001.ext``, ``name_s002.ext`` ... in
row-major order: crops of ``crop-size`` every ``step`` pixels, plus one flush
with the far edge where the remainder there is larger than ``thresh-size``.
``--n-thread 1`` crops in this process; more start a pool of that many
spawned processes.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from os import path as osp

import cv2
import numpy as np

from ...utils.misc import scandir


def crop_starts(size, crop_size, step, thresh_size):
    """The start of every crop along one side of ``size`` pixels."""
    space = np.arange(0, size - crop_size + 1, step)
    if size - (space[-1] + crop_size) > thresh_size:
        space = np.append(space, size - crop_size)
    return space


def worker(path, opt):
    """Write the sub-images of the image at ``path``; returns a report line."""
    crop_size = opt.crop_size
    img_name, extension = osp.splitext(osp.basename(path))
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    h, w = img.shape[:2]
    index = 0
    for x in crop_starts(h, crop_size, opt.step, opt.thresh_size):
        for y in crop_starts(w, crop_size, opt.step, opt.thresh_size):
            index += 1
            cropped = np.ascontiguousarray(img[x:x + crop_size, y:y + crop_size, ...])
            cv2.imwrite(osp.join(opt.output, f'{img_name}_s{index:03d}{extension}'), cropped,
                        [cv2.IMWRITE_PNG_COMPRESSION, opt.compression_level])
    return f'{img_name}: {index} patches'


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--input', required=True, help='input image folder')
    p.add_argument('--output', required=True, help='output folder for sub-images')
    p.add_argument('--crop-size', type=int, default=480)
    p.add_argument('--step', type=int, default=240)
    p.add_argument('--thresh-size', type=int, default=0,
                   help='drop remainder patches smaller than this')
    p.add_argument('--n-thread', type=int, default=20)
    p.add_argument('--compression-level', type=int, default=3)
    opt = p.parse_args(argv)

    if osp.exists(opt.output):
        print(f'Folder {opt.output} already exists. Exit.')
        sys.exit(1)
    os.makedirs(opt.output)

    img_list = list(scandir(opt.input, full_path=True))
    if opt.n_thread <= 1:
        for path in img_list:
            print(worker(path, opt), flush=True)
    else:
        pool = multiprocessing.get_context('spawn').Pool(opt.n_thread)
        for path in img_list:
            pool.apply_async(worker, args=(path, opt),
                             callback=lambda msg: print(msg, flush=True))
        pool.close()
        pool.join()
    print('All processes done.')


if __name__ == '__main__':
    main()
