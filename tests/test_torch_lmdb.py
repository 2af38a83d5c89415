"""The port's LMDB layer against the JAX package's, on the CPU:
``utils/lmdb_util.py`` (``make_lmdb_from_imgs``, ``LmdbMaker``),
``data_util.paired_paths_from_lmdb`` and the LMDB modes of
``PairedImageDataset``, ``SingleImageDataset``, ``REDSDataset`` (with its flow
client) and ``REDSRecurrentDataset``.

``lmdb`` is not installed here, so a test-only stand-in takes its place in
``sys.modules``: an in-memory map from an environment's path to its
{key: bytes}, which creates the folder as ``lmdb.open`` does. Images are
crops of ``tests/data/baboon.png`` and frames drawn from a seeded numpy
generator. Tolerance: none; keys, bytes, ``meta_info.txt`` and items are
equal exactly (both packages decode the same PNG bytes and draw from
generators with the same seed).
"""

import os
import sys
import types
from multiprocessing.pool import ThreadPool
from os import path as osp

import cv2
import numpy as np
import pytest
import torch

from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.data import data_util as port_data_util
from basicsr4rs_torch.scripts.data_preparation import create_lmdb as port_create_lmdb
from basicsr4rs_torch.utils import lmdb_util as port_lmdb_util
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.data import data_util as jax_data_util
from basicsr4rs_tpu.utils import lmdb_util as jax_lmdb_util

BABOON = osp.join(osp.dirname(__file__), 'data', 'baboon.png')
SCALE = 4


class _Txn:

    def __init__(self, store):
        self.store = store

    def put(self, key, value):
        self.store[bytes(key)] = bytes(value)

    def get(self, key):
        return self.store.get(bytes(key))

    def commit(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Env:

    def __init__(self, store):
        self.store = store

    def begin(self, write=False):
        return _Txn(self.store)

    def close(self):
        pass


def lmdb_stand_in():
    """A module with ``open(path, ...)``: the environment of ``path`` (made
    with its folder on first use); ``stores`` maps each path to its
    {key: bytes}, ``opened`` lists the paths in the order they were opened."""
    module = types.ModuleType('lmdb')
    module.stores, module.opened = {}, []

    def open_(path, map_size=None, readonly=False, lock=True, readahead=True, **kwargs):
        path = osp.abspath(str(path))
        os.makedirs(path, exist_ok=True)
        module.opened.append(path)
        return _Env(module.stores.setdefault(path, {}))

    module.open = open_
    return module


@pytest.fixture
def fake_lmdb(monkeypatch):
    module = lmdb_stand_in()
    monkeypatch.setitem(sys.modules, 'lmdb', module)
    return module


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    """GT crops of baboon.png (32x32, and one 40x36), their x4 LQ, a grey
    crop, and REDS-style clips of frames."""
    root = tmp_path_factory.mktemp('lmdb_images')
    img = cv2.imread(BABOON)
    for sub in ('GT', 'LQ', 'grey'):
        (root / sub).mkdir()
    for i, (y, x, h, w) in enumerate([(0, 0, 32, 32), (50, 71, 32, 32), (120, 9, 40, 36),
                                      (200, 300, 32, 32)]):
        gt = img[y:y + h, x:x + w]
        cv2.imwrite(str(root / 'GT' / f'{i:04d}.png'), gt)
        cv2.imwrite(str(root / 'LQ' / f'{i:04d}.png'),
                    cv2.resize(gt, (w // SCALE, h // SCALE), interpolation=cv2.INTER_AREA))
    cv2.imwrite(str(root / 'grey' / 'g.png'), cv2.cvtColor(img[:20, :24], cv2.COLOR_BGR2GRAY))
    rng = np.random.RandomState(0)
    for clip, frames in (('100', 7), ('101', 5), ('011', 6)):
        for sub, (h, w) in (('clips_GT', (48, 64)), ('clips_LQ', (12, 16))):
            (root / sub / clip).mkdir(parents=True)
            for t in range(frames):
                cv2.imwrite(str(root / sub / clip / f'{t:08d}.png'),
                            (rng.rand(h, w, 3) * 255).astype(np.uint8))
    (root / 'meta_reds.txt').write_text('100 7 (48,64,3)\n101 5 (48,64,3)\n011 6 (48,64,3)\n')
    return root


def store_of(module, path):
    return module.stores[osp.abspath(str(path))]


def write_lmdb(lmdb_util, folder, out, keys_fn=port_create_lmdb.prepare_keys_div2k):
    paths, keys = keys_fn(str(folder))
    lmdb_util.make_lmdb_from_imgs(str(folder), str(out), paths, keys, batch=2)


@pytest.mark.parametrize('writer', ['make_lmdb_from_imgs', 'read-in-processes', 'LmdbMaker'])
def test_writers_match_jax(images, tmp_path, fake_lmdb, monkeypatch, writer):
    """The same keys, PNG bytes and ``meta_info.txt`` from both packages,
    colour and grey images, commits every 2 images; with
    ``multiprocessing_read`` the port reads in two spawned processes (the JAX
    package's pool runs as threads here: a fork of this process, which holds
    JAX's threads, warns)."""
    monkeypatch.setattr(jax_lmdb_util, 'Pool', ThreadPool)
    names = ['0000.png', '0002.png', 'g.png']
    folders = [images / 'GT', images / 'GT', images / 'grey']
    outs = {}
    for tag, util in (('port', port_lmdb_util), ('jax', jax_lmdb_util)):
        out = str(tmp_path / f'{tag}.lmdb')
        if writer != 'LmdbMaker':
            util.make_lmdb_from_imgs(str(images), out, [f'{f.name}/{n}' for f, n in
                                                        zip(folders, names)],
                                     ['a', 'b', 'c'], batch=2, compress_level=3,
                                     multiprocessing_read=writer != 'make_lmdb_from_imgs',
                                     n_thread=2)
        else:
            maker = util.LmdbMaker(out, batch=2, compress_level=3)
            for folder, name, key in zip(folders, names, 'abc'):
                img = cv2.imread(str(folder / name), cv2.IMREAD_UNCHANGED)
                _, img_byte = cv2.imencode('.png', img, [cv2.IMWRITE_PNG_COMPRESSION, 3])
                shape = img.shape if img.ndim == 3 else (*img.shape, 1)
                maker.put(img_byte, key, shape)
            maker.close()
        outs[tag] = (store_of(fake_lmdb, out), (tmp_path / f'{tag}.lmdb' / 'meta_info.txt')
                     .read_text())
    assert outs['port'] == outs['jax']
    store, meta = outs['port']
    assert sorted(store) == [b'a', b'b', b'c']
    assert meta == 'a.png (32,32,3) 3\nb.png (40,36,3) 3\nc.png (20,24,1) 3\n'


def test_writers_refuse_as_jax(images, tmp_path, fake_lmdb):
    """A path without ``.lmdb`` raises, an existing folder exits, unequal
    lists raise, in both packages."""
    (tmp_path / 'old.lmdb').mkdir()
    for util in (port_lmdb_util, jax_lmdb_util):
        with pytest.raises(ValueError, match='.lmdb'):
            util.LmdbMaker(str(tmp_path / 'x'))
        with pytest.raises(ValueError, match='.lmdb'):
            util.make_lmdb_from_imgs(str(images / 'GT'), str(tmp_path / 'x'), ['0000.png'], ['a'])
        with pytest.raises(SystemExit):
            util.LmdbMaker(str(tmp_path / 'old.lmdb'))
    with pytest.raises(ValueError, match='same length'):
        port_lmdb_util.make_lmdb_from_imgs(str(images), str(tmp_path / 'y.lmdb'), ['a'], [])
    with pytest.raises(AssertionError, match='same length'):
        jax_lmdb_util.make_lmdb_from_imgs(str(images), str(tmp_path / 'y.lmdb'), ['a'], [])


def test_without_lmdb_both_packages_raise(images, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'lmdb', None)
    for util in (port_lmdb_util, jax_lmdb_util):
        with pytest.raises(ImportError, match='lmdb'):
            util.LmdbMaker(str(tmp_path / 'a.lmdb'))
        with pytest.raises(ImportError, match='lmdb'):
            write_lmdb(util, images / 'GT', tmp_path / 'b.lmdb')
    assert not (tmp_path / 'a.lmdb').exists() and not (tmp_path / 'b.lmdb').exists()


def test_paired_paths_from_lmdb_matches_jax(images, tmp_path, fake_lmdb):
    write_lmdb(port_lmdb_util, images / 'GT', tmp_path / 'gt.lmdb')
    write_lmdb(port_lmdb_util, images / 'LQ', tmp_path / 'lq.lmdb')
    folders = [str(tmp_path / 'lq.lmdb'), str(tmp_path / 'gt.lmdb')]
    got = port_data_util.paired_paths_from_lmdb(folders, ['lq', 'gt'])
    assert got == jax_data_util.paired_paths_from_lmdb(folders, ['lq', 'gt'])
    assert got[1] == {'lq_path': '0001', 'gt_path': '0001'} and len(got) == 4
    with pytest.raises(ValueError, match='lmdb'):
        port_data_util.paired_paths_from_lmdb([str(images / 'LQ'), folders[1]], ['lq', 'gt'])
    (tmp_path / 'other.lmdb').mkdir()
    (tmp_path / 'other.lmdb' / 'meta_info.txt').write_text('0000.png (8,8,3) 1\n')
    with pytest.raises(ValueError, match='different'):
        port_data_util.paired_paths_from_lmdb([str(tmp_path / 'other.lmdb'), folders[1]],
                                              ['lq', 'gt'])


def assert_same_items(port, ref, passes=2):
    """Every item of both datasets, ``passes`` times in order: tensors equal
    to the JAX arrays moved to the port's layout, the rest equal."""
    assert len(port) == len(ref)
    for _ in range(passes):
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            assert got.keys() == want.keys()
            for key, value in want.items():
                if isinstance(value, np.ndarray):
                    assert torch.is_tensor(got[key])
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  np.moveaxis(value, -1, -3), err_msg=key)
                else:
                    assert got[key] == value, key


@pytest.mark.parametrize('phase', ['train', 'val'])
def test_paired_image_dataset_lmdb_mode(images, tmp_path, fake_lmdb, phase):
    write_lmdb(port_lmdb_util, images / 'GT', tmp_path / 'gt.lmdb')
    write_lmdb(port_lmdb_util, images / 'LQ', tmp_path / 'lq.lmdb')
    opt = {'name': 'pairs', 'type': 'PairedImageDataset', 'phase': phase, 'scale': SCALE,
           'dataroot_gt': str(tmp_path / 'gt.lmdb'), 'dataroot_lq': str(tmp_path / 'lq.lmdb'),
           'io_backend': {'type': 'lmdb'}, 'gt_size': 16, 'use_hflip': True, 'use_rot': True,
           'manual_seed': 5}
    port = port_build_dataset(dict(opt))
    assert port.file_client.client._envs is None   # opened at the first item
    assert_same_items(port, jax_build_dataset(dict(opt)))
    assert port[2]['gt_path'] == '0002'
    assert port[2]['gt'].shape == ((3, 16, 16) if phase == 'train' else (3, 40, 36))


@pytest.mark.parametrize('color', ['rgb', 'y'])
def test_single_image_dataset_lmdb_mode(images, tmp_path, fake_lmdb, color):
    write_lmdb(port_lmdb_util, images / 'LQ', tmp_path / 'lq.lmdb')
    opt = {'name': 'single', 'type': 'SingleImageDataset', 'phase': 'test',
           'dataroot_lq': str(tmp_path / 'lq.lmdb'), 'io_backend': {'type': 'lmdb'}}
    if color == 'y':
        opt['color'] = 'y'
    port = port_build_dataset(dict(opt))
    assert port.paths == ['0000', '0001', '0002', '0003']
    assert_same_items(port, jax_build_dataset(dict(opt)), passes=1)


@pytest.mark.parametrize('cls, extra', [
    ('REDSDataset', dict(num_frame=3, interval_list=[1, 2], random_reverse=True)),
    ('REDSDataset', dict(num_frame=5, flow=True)),
    ('REDSRecurrentDataset', dict(num_frame=4, random_reverse=True)),
], ids=['reds-interval-reverse', 'reds-flow', 'recurrent'])
def test_reds_datasets_lmdb_mode(images, tmp_path, fake_lmdb, cls, extra):
    """Frames under the keys ``<clip>/<frame:08d>`` that ``create_lmdb``'s
    REDS rule gives; with ``dataroot_flow`` both packages open the flow
    root as a third client (after LQ and GT) and read nothing from it."""
    for sub in ('GT', 'LQ'):
        write_lmdb(port_lmdb_util, images / f'clips_{sub}', tmp_path / f'{sub}.lmdb',
                   port_create_lmdb.prepare_keys_reds)
    assert b'100/00000006' in store_of(fake_lmdb, tmp_path / 'GT.lmdb')
    flow = extra.pop('flow', False)
    opt = dict(name='reds', type=cls, phase='train', scale=SCALE,
               dataroot_gt=str(tmp_path / 'GT.lmdb'), dataroot_lq=str(tmp_path / 'LQ.lmdb'),
               meta_info_file=str(images / 'meta_reds.txt'), val_partition='REDS4',
               io_backend={'type': 'lmdb'}, gt_size=32, interval_list=[1],
               random_reverse=False, use_hflip=True, use_rot=True, manual_seed=3)
    opt.update(extra)
    if flow:
        opt['dataroot_flow'] = str(tmp_path / 'flow.lmdb')
    opened = []
    for build in (port_build_dataset, jax_build_dataset):
        start = len(fake_lmdb.opened)
        dataset = build(dict(opt))
        dataset[0]
        opened.append(fake_lmdb.opened[start:])
    assert opened[0] == opened[1] == [str(tmp_path / name) for name in
                                      ('LQ.lmdb', 'GT.lmdb', 'flow.lmdb')[:3 if flow else 2]]
    port, ref = port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert port.keys == ref.keys and len(port) == 12
    assert_same_items(port, ref)
