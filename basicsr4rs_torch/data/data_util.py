"""Dataset path helpers (counterpart of ``basicsr4rs_tpu/data/data_util.py``;
reference: basicsr/data/data_util.py). The image pairs by folder scan and
by meta-info file and by LMDB keys, the LMDB key list, the video helpers
and DUF's downsampling."""

from __future__ import annotations

from os import path as osp
from typing import List, Sequence

import cv2
import numpy as np
import torch

from ..utils.img_util import img2tensor
from ..utils.misc import scandir
from .transforms import mod_crop


def read_img_seq(path, require_mod_crop: bool = False, scale: int = 1,
                 return_imgname: bool = False):
    """Read the frames of a folder (sorted) or of a list of paths into a
    (T, C, H, W) float32 RGB tensor in [0, 1]; with ``return_imgname`` also
    the frames' names without extension."""
    if isinstance(path, list):
        img_paths = path
    else:
        img_paths = sorted(scandir(path, full_path=True))
    imgs = [cv2.imread(v).astype(np.float32) / 255. for v in img_paths]
    if require_mod_crop:
        imgs = [mod_crop(img, scale) for img in imgs]
    imgs = torch.stack(img2tensor(imgs, bgr2rgb=True, float32=True), dim=0)
    if return_imgname:
        return imgs, [osp.splitext(osp.basename(p))[0] for p in img_paths]
    return imgs


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = 'reflection') -> List[int]:
    """The ``num_frames`` frame indices of the window centred at ``crt_idx``
    (0-based) in a clip of ``max_frame_num`` frames. At the clip's start,
    for 5 frames around frame 0:

    replicate:          [0, 0, 0, 1, 2]
    reflection:         [2, 1, 0, 1, 2]
    reflection_circle:  [4, 3, 0, 1, 2]
    circle:             [3, 4, 0, 1, 2]
    """
    if num_frames % 2 != 1:
        raise ValueError('num_frames should be an odd number.')
    if padding not in ('replicate', 'reflection', 'reflection_circle', 'circle'):
        raise ValueError(f'Wrong padding mode: {padding}.')
    last = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            pad_idx = {'replicate': 0, 'reflection': -i,
                       'reflection_circle': crt_idx + num_pad - i,
                       'circle': num_frames + i}[padding]
        elif i > last:
            pad_idx = {'replicate': last, 'reflection': last * 2 - i,
                       'reflection_circle': (crt_idx - num_pad) - (i - last),
                       'circle': i - num_frames}[padding]
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def paired_paths_from_lmdb(folders: Sequence[str], keys: Sequence[str]) -> List[dict]:
    """Pair the keys of two ``.lmdb`` folders, read from their
    ``meta_info.txt`` files (the name before the first dot on each line);
    both folders must hold the same keys. Each pair names one key twice,
    sorted by key."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired_paths_from_lmdb takes [input_folder, gt_folder] '
                         'and [input_key, gt_key]')
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (input_folder.endswith('.lmdb') and gt_folder.endswith('.lmdb')):
        raise ValueError(f'{input_key} folder and {gt_key} folder should both in lmdb '
                         f'formats. But received {input_key}: {input_folder}; '
                         f'{gt_key}: {gt_folder}')
    input_lmdb_keys, gt_lmdb_keys = paths_from_lmdb(input_folder), paths_from_lmdb(gt_folder)
    if set(input_lmdb_keys) != set(gt_lmdb_keys):
        raise ValueError(f'Keys in {input_key}_folder and {gt_key}_folder are different.')
    return [{f'{input_key}_path': key, f'{gt_key}_path': key}
            for key in sorted(input_lmdb_keys)]


def paired_paths_from_meta_info_file(folders: Sequence[str], keys: Sequence[str],
                                     meta_info_file: str, filename_tmpl: str) -> List[dict]:
    """Pair the GT files a meta-info file lists (the first word of each
    line, relative to the GT folder) with the inputs
    ``filename_tmpl.format(name).ext``; the files are not looked up."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired_paths_from_meta_info_file takes [input_folder, gt_folder] '
                         'and [input_key, gt_key]')
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, 'r') as fin:
        gt_names = [line.strip().split(' ')[0] for line in fin]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        paths.append({f'{input_key}_path': osp.join(input_folder,
                                                    f'{filename_tmpl.format(basename)}{ext}'),
                      f'{gt_key}_path': osp.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_folder(folders: Sequence[str], keys: Sequence[str],
                             filename_tmpl: str) -> List[dict]:
    """Pair the files of two folders by name: each GT file ``name.ext`` with
    the input ``filename_tmpl.format(name).ext``."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired_paths_from_folder takes [input_folder, gt_folder] '
                         'and [input_key, gt_key]')
    input_folder, gt_folder = folders
    input_key, gt_key = keys

    input_names = {osp.basename(p) for p in scandir(input_folder)}
    gt_paths = list(scandir(gt_folder))
    if len(input_names) != len(gt_paths):
        raise ValueError(f'{input_key} and {gt_key} datasets have different number of '
                         f'images: {len(input_names)}, {len(gt_paths)}.')
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        if input_name not in input_names:
            raise ValueError(f'{input_name} is not in {input_key}_paths.')
        paths.append({f'{input_key}_path': osp.join(input_folder, input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_path)})
    return paths


def paths_from_lmdb(folder: str) -> List[str]:
    """The keys of an LMDB folder, from its ``meta_info.txt`` (the name
    before the first dot on each line)."""
    if not folder.endswith('.lmdb'):
        raise ValueError(f'Folder {folder} should be in lmdb format.')
    with open(osp.join(folder, 'meta_info.txt')) as fin:
        return [line.split('.')[0] for line in fin]


def generate_gaussian_kernel(kernel_size: int = 13, sigma: float = 1.6) -> np.ndarray:
    """DUF's Gaussian filter: a Dirac delta smoothed by
    ``scipy.ndimage.gaussian_filter`` (float64, ``kernel_size`` square)."""
    from scipy.ndimage import gaussian_filter
    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x, kernel_size: int = 13, scale: int = 4):
    """DUF's downsampling protocol on the host: each frame reflect-padded by
    ``kernel_size // 2 + 2 * scale``, blurred by the Gaussian of sigma
    ``0.4 * scale``, sampled every ``scale`` pixels at the positions of a
    valid convolution, and cut by 2 samples at each border.

    Args:
      x: (T, C, H, W) or (C, H, W) float tensor, or the same layouts as a
        numpy array.
    Returns the downsampled frames in the input's type and layout.
    """
    if scale not in (2, 3, 4):
        raise ValueError(f'Only support scale (2, 3, 4), but got {scale}.')
    is_tensor = torch.is_tensor(x)
    frames = x.detach().cpu().numpy() if is_tensor else np.asarray(x)
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    pad = kernel_size // 2 + scale * 2
    half = kernel_size // 2
    kernel = generate_gaussian_kernel(kernel_size, 0.4 * scale)
    out = []
    for frame in frames:
        frame = np.pad(frame.transpose(1, 2, 0), ((pad, pad), (pad, pad), (0, 0)), mode='reflect')
        blurred = cv2.filter2D(frame, -1, kernel, borderType=cv2.BORDER_CONSTANT)
        if blurred.ndim == 2:
            blurred = blurred[:, :, None]
        valid = blurred[half:frame.shape[0] - half:scale, half:frame.shape[1] - half:scale]
        out.append(valid[2:-2, 2:-2].transpose(2, 0, 1))
    out = np.ascontiguousarray(np.stack(out, axis=0))
    out = out[0] if squeeze else out
    return torch.from_numpy(out) if is_tensor else out
