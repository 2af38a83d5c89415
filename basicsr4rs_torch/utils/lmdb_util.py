"""LMDB dataset builders (counterpart of ``basicsr4rs_tpu/utils/lmdb_util.py``;
reference: basicsr/utils/lmdb_util.py).

An ``.lmdb`` folder holds ``data.mdb`` (each image PNG-encoded under its key)
and ``meta_info.txt`` with one ``key.png (h,w,c) compress_level`` line per
image, the reference's layout, so the datasets of both packages read it.
``lmdb`` is optional: it is imported when a builder starts, and its absence
raises ``ImportError`` there.
"""

from __future__ import annotations

import multiprocessing
import sys
from os import path as osp


def _require_lmdb():
    try:
        import lmdb
        return lmdb
    except ImportError as e:
        raise ImportError('lmdb is required for LMDB dataset creation: '
                          'pip install lmdb') from e


def read_img_worker(path, key, compress_level):
    """Read one image and PNG-encode it; returns (key, bytes, (h, w, c))."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        h, w = img.shape
        c = 1
    else:
        h, w, c = img.shape
    _, img_byte = cv2.imencode('.png', img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
    return (key, img_byte, (h, w, c))


def _check_new_lmdb_path(lmdb_path):
    if not lmdb_path.endswith('.lmdb'):
        raise ValueError("lmdb_path must end with '.lmdb'.")
    if osp.exists(lmdb_path):
        print(f'Folder {lmdb_path} already exists. Exit.')
        sys.exit(1)


def make_lmdb_from_imgs(data_path, lmdb_path, img_path_list, keys, batch=5000,
                        compress_level=1, multiprocessing_read=False,
                        n_thread=40, map_size=None):
    """Build an ``.lmdb`` folder from the images ``img_path_list`` (relative
    to ``data_path``) under ``keys`` (the names without extension).
    ``multiprocessing_read`` reads them all first in ``n_thread`` spawned
    processes; ``map_size`` defaults to ten times the first image's PNG size
    per image. The transaction is committed every ``batch`` images."""
    import cv2
    lmdb = _require_lmdb()
    if len(img_path_list) != len(keys):
        raise ValueError('img_path_list and keys should have the same length, '
                         f'but got {len(img_path_list)} and {len(keys)}')
    print(f'Create lmdb for {data_path}, save to {lmdb_path}...')
    print(f'Total images: {len(img_path_list)}')
    _check_new_lmdb_path(lmdb_path)

    dataset, shapes = {}, {}
    if multiprocessing_read:
        print(f'Read images with multiprocessing, #thread: {n_thread} ...')

        def callback(arg):
            key, dataset[key], shapes[key] = arg

        pool = multiprocessing.get_context('spawn').Pool(n_thread)
        for path, key in zip(img_path_list, keys):
            pool.apply_async(read_img_worker, args=(osp.join(data_path, path), key,
                                                    compress_level), callback=callback)
        pool.close()
        pool.join()
        print(f'Finish reading {len(img_path_list)} images.')

    if map_size is None:
        img = cv2.imread(osp.join(data_path, img_path_list[0]), cv2.IMREAD_UNCHANGED)
        _, img_byte = cv2.imencode('.png', img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        data_size_per_img = img_byte.nbytes
        print('Data size per image is: ', data_size_per_img)
        map_size = data_size_per_img * len(img_path_list) * 10

    env = lmdb.open(lmdb_path, map_size=map_size)
    txn = env.begin(write=True)
    with open(osp.join(lmdb_path, 'meta_info.txt'), 'w') as txt_file:
        for idx, (path, key) in enumerate(zip(img_path_list, keys)):
            if multiprocessing_read:
                img_byte, (h, w, c) = dataset[key], shapes[key]
            else:
                _, img_byte, (h, w, c) = read_img_worker(
                    osp.join(data_path, path), key, compress_level)
            txn.put(key.encode('ascii'), img_byte)
            txt_file.write(f'{key}.png ({h},{w},{c}) {compress_level}\n')
            if idx % batch == 0:
                txn.commit()
                txn = env.begin(write=True)
    txn.commit()
    env.close()
    print('\nFinish writing lmdb.')


class LmdbMaker:
    """Incremental LMDB writer in the same layout: ``put`` PNG bytes under a
    key, ``close`` at the end; commits every ``batch`` images."""

    def __init__(self, lmdb_path, map_size=1024**4, batch=5000, compress_level=1):
        lmdb = _require_lmdb()
        _check_new_lmdb_path(lmdb_path)
        self.lmdb_path = lmdb_path
        self.batch = batch
        self.compress_level = compress_level
        self.env = lmdb.open(lmdb_path, map_size=map_size)
        self.txn = self.env.begin(write=True)
        self.txt_file = open(osp.join(lmdb_path, 'meta_info.txt'), 'w')
        self.counter = 0

    def put(self, img_byte, key, img_shape):
        self.counter += 1
        self.txn.put(key.encode('ascii'), img_byte)
        h, w, c = img_shape
        self.txt_file.write(f'{key}.png ({h},{w},{c}) {self.compress_level}\n')
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self):
        self.txn.commit()
        self.env.close()
        self.txt_file.close()
