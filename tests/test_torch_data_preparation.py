"""The port's data-preparation scripts (``basicsr4rs_torch/scripts/
data_preparation/``) against the repository's root scripts, on files the
tests write from crops of ``tests/data/baboon.png`` and seeded numpy draws.

Each root script's ``main`` runs in this process with a patched
``sys.argv`` (its process pools swapped for one thread: a forked copy of
this process would only slow it down); the port's ``main`` takes its
arguments with ``--n-thread 1`` where it has a pool. Tolerance: none; file
names, pixels, text, key lists and trees are equal exactly.
"""

import functools
import importlib.util
import pathlib
import struct
import sys
from multiprocessing.pool import ThreadPool

import cv2
import numpy as np
import pytest

from basicsr4rs_torch.scripts.data_preparation import create_lmdb as port_create_lmdb
from basicsr4rs_torch.scripts.data_preparation import \
    extract_images_from_tfrecords as port_tfrecords
from basicsr4rs_torch.scripts.data_preparation import extract_subimages as port_extract
from basicsr4rs_torch.scripts.data_preparation import generate_bicubic_lr as port_bicubic
from basicsr4rs_torch.scripts.data_preparation import generate_meta_info as port_meta
from basicsr4rs_torch.scripts.data_preparation import prepare_hifacegan_dataset as port_hifacegan
from basicsr4rs_torch.scripts.data_preparation import regroup_reds_dataset as port_regroup
from basicsr4rs_tpu.utils import lmdb_util as jax_lmdb_util
from test_torch_lmdb import lmdb_stand_in

ROOT = pathlib.Path(__file__).resolve().parents[1]
BABOON = str(ROOT / 'tests' / 'data' / 'baboon.png')


@functools.cache
def root_script(name):
    """The root script ``scripts/data_preparation/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f'root_data_preparation_{name}', ROOT / 'scripts' / 'data_preparation' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_root(monkeypatch, name, argv):
    module = root_script(name)
    monkeypatch.setattr(sys, 'argv', [f'{name}.py'] + [str(a) for a in argv])
    if hasattr(module, 'Pool'):
        monkeypatch.setattr(module, 'Pool', ThreadPool)
    module.main()


def tree(root):
    """{relative path: decoded pixels, or the bytes of a file that is not an
    image} of every file under ``root``."""
    out = {}
    for path in sorted(p for p in pathlib.Path(root).rglob('*') if p.is_file()):
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        out[str(path.relative_to(root))] = path.read_bytes() if img is None else img
    return out


def assert_same_tree(got_root, want_root):
    got, want = tree(got_root), tree(want_root)
    assert list(got) == list(want)
    for name, value in want.items():
        if isinstance(value, bytes):
            assert got[name] == value, name
        else:
            assert got[name].dtype == value.dtype, name
            np.testing.assert_array_equal(got[name], value, err_msg=name)
    return got


@pytest.fixture(scope='module')
def hr(tmp_path_factory):
    """Three HR images: two colour crops of baboon.png (not multiples of the
    crop steps) and a grey one."""
    root = tmp_path_factory.mktemp('hr')
    img = cv2.imread(BABOON)
    cv2.imwrite(str(root / 'a.png'), img[:150, :131])
    cv2.imwrite(str(root / 'b.png'), img[200:296, 100:197])
    cv2.imwrite(str(root / 'c.png'), cv2.cvtColor(img[300:370, 40:123], cv2.COLOR_BGR2GRAY))
    return root


@pytest.mark.parametrize('thresh, n_thread', [(0, 1), (20, 2)])
def test_extract_subimages_matches_root(hr, tmp_path, monkeypatch, thresh, n_thread):
    """Crop 64, step 32: with threshold 0 every remainder gets a crop flush
    with the far edge; at 20, only remainders past 20 pixels. The port crops
    in this process (1) or in two spawned processes (2)."""
    args = ['--crop-size', 64, '--step', 32, '--thresh-size', thresh, '--compression-level', 1]
    port_extract.main([str(a) for a in ['--input', hr, '--output', tmp_path / 'port',
                                        '--n-thread', n_thread] + args])
    run_root(monkeypatch, 'extract_subimages', ['--input', hr, '--output', tmp_path / 'root',
                                                '--n-thread', 1] + args)
    got = assert_same_tree(tmp_path / 'port', tmp_path / 'root')
    # a.png 150x131: rows 0, 32, 64 and 86 (remainder 22), columns 0, 32, 64
    # and 67 (remainder 3, dropped at 20)
    assert sum(name.startswith('a_s') for name in got) == (4 * 4 if thresh == 0 else 4 * 3)
    assert got['a_s001.png'].shape == (64, 64, 3) and got['c_s001.png'].shape == (64, 64)


@pytest.mark.parametrize('scale, restore', [(4, False), (3, True)], ids=['x4', 'x3-restore'])
def test_generate_bicubic_lr_matches_root(hr, tmp_path, monkeypatch, scale, restore):
    """Recursively, with an image that is not a multiple of the scale; the
    ``--mod`` flag writes nothing more in either script."""
    nested = tmp_path / 'in' / 'sub'
    nested.mkdir(parents=True)
    img = cv2.imread(str(hr / 'a.png'))
    cv2.imwrite(str(tmp_path / 'in' / 'x.png'), img[:47, :53])
    cv2.imwrite(str(nested / 'y.png'), img[:48, :36])
    for tag in ('port', 'root'):
        argv = ['--input', tmp_path / 'in', '--output', tmp_path / tag, '--scale', scale, '--mod']
        if restore:
            argv += ['--bicubic_restore', tmp_path / f'{tag}_bic']
        if tag == 'port':
            port_bicubic.main([str(a) for a in argv])
        else:
            run_root(monkeypatch, 'generate_bicubic_lr', argv)
    got = assert_same_tree(tmp_path / 'port', tmp_path / 'root')
    assert got['x.png'].shape == (47 // scale, 53 // scale, 3)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ['in', 'port', 'root'] + (['port_bic', 'root_bic'] if restore else []))
    if restore:
        bic = assert_same_tree(tmp_path / 'port_bic', tmp_path / 'root_bic')
        assert bic['sub/y.png'].shape == (48, 36, 3)


def test_generate_meta_info_matches_root(hr, tmp_path, monkeypatch):
    folder = tmp_path / 'imgs'
    folder.mkdir()
    for name in ('b.png', 'c.png', 'a.png'):
        (folder / name).write_bytes((hr / name).read_bytes())
    (folder / 'notes.txt').write_text('not an image')
    port_meta.main(['--input', str(folder), '--output', str(tmp_path / 'port.txt')])
    run_root(monkeypatch, 'generate_meta_info',
             ['--input', folder, '--output', tmp_path / 'root.txt'])
    text = (tmp_path / 'port.txt').read_text()
    assert text == (tmp_path / 'root.txt').read_text()
    assert text == 'a.png (150,131,3)\nb.png (96,97,3)\nc.png (70,83,1)\n'


def test_create_lmdb_key_rules_match_root(tmp_path):
    """The three key rules on the same folders."""
    root = root_script('create_lmdb')
    div2k = tmp_path / 'div2k'
    reds = tmp_path / 'reds'
    vimeo = tmp_path / 'vimeo'
    for folder, names in ((div2k, ['0002.png', '0001.png', 'x.jpg']),
                          (reds, ['001/00000001.png', '000/00000000.png', '000/00000001.png']),
                          (vimeo, ['00001/0001/im1.png'])):
        for name in names:
            (folder / name).parent.mkdir(parents=True, exist_ok=True)
            (folder / name).write_bytes(b'')
    (tmp_path / 'list.txt').write_text('00001/0001\n00001/0002\n\n')
    for port_fn, root_fn, args in (
            (port_create_lmdb.prepare_keys_div2k, root.prepare_keys_div2k, [str(div2k)]),
            (port_create_lmdb.prepare_keys_reds, root.prepare_keys_reds, [str(reds)]),
            (port_create_lmdb.prepare_keys_vimeo90k, root.prepare_keys_vimeo90k,
             [str(vimeo), str(tmp_path / 'list.txt')])):
        assert port_fn(*args) == root_fn(*args)
    assert port_create_lmdb.prepare_keys_div2k(str(div2k))[1] == ['0001', '0002']
    assert port_create_lmdb.prepare_keys_reds(str(reds))[1] == [
        '000/00000000', '000/00000001', '001/00000001']
    paths, keys = port_create_lmdb.prepare_keys_vimeo90k(str(vimeo), str(tmp_path / 'list.txt'))
    assert len(keys) == 14 and keys[7] == '00001/0002/im1' and paths[0] == '00001/0001/im1.png'


def test_create_lmdb_writes_as_root_and_holds_the_gate(hr, tmp_path, monkeypatch):
    """``--dataset div2k`` under the lmdb stand-in: the same keys, bytes and
    ``meta_info.txt``; without ``lmdb`` it raises ``ImportError``."""
    fake = lmdb_stand_in()
    monkeypatch.setitem(sys.modules, 'lmdb', fake)
    monkeypatch.setattr(jax_lmdb_util, 'Pool', ThreadPool)
    port_create_lmdb.main(['--dataset', 'div2k', '--input', str(hr), '--output',
                           str(tmp_path / 'port.lmdb'), '--n-thread', '1'])
    run_root(monkeypatch, 'create_lmdb', ['--dataset', 'div2k', '--input', hr, '--output',
                                          tmp_path / 'root.lmdb', '--n-thread', 1])
    stores = [fake.stores[str(tmp_path / f'{tag}.lmdb')] for tag in ('port', 'root')]
    assert stores[0] == stores[1] and sorted(stores[0]) == [b'a', b'b', b'c']
    assert ((tmp_path / 'port.lmdb' / 'meta_info.txt').read_text()
            == (tmp_path / 'root.lmdb' / 'meta_info.txt').read_text())
    monkeypatch.setitem(sys.modules, 'lmdb', None)
    with pytest.raises(ImportError, match='lmdb'):
        port_create_lmdb.main(['--dataset', 'div2k', '--input', str(hr), '--output',
                               str(tmp_path / 'gate.lmdb')])


def test_regroup_reds_matches_root(tmp_path, monkeypatch):
    """Validation clips 000 and 003 become 240 and 243 beside the training
    clips, sharp and blur."""
    for tag in ('port', 'root'):
        argv = []
        for split, clips in (('train', ('000', '001')), ('val', ('000', '003'))):
            for kind in ('sharp', 'blur'):
                argv += [f'--{split}-{kind}', str(tmp_path / tag / f'{split}_{kind}')]
                for clip in clips:
                    folder = tmp_path / tag / f'{split}_{kind}' / clip
                    folder.mkdir(parents=True)
                    for t in range(2):
                        frame = np.random.RandomState(t + int(clip)).rand(4, 5, 3) * 255
                        cv2.imwrite(str(folder / f'{t:08d}.png'), frame.astype(np.uint8))
        if tag == 'port':
            port_regroup.main(argv)
        else:
            run_root(monkeypatch, 'regroup_reds_dataset', argv)
    got = assert_same_tree(tmp_path / 'port', tmp_path / 'root')
    assert 'train_blur/243/00000001.png' in got and 'train_sharp/240/00000000.png' in got


@pytest.mark.parametrize('deg', ['sr4x', 'sr4x8x', 'mosaic', 'denoise', 'dejpeg', 'full'])
def test_prepare_hifacegan_matches_root(tmp_path, monkeypatch, deg):
    """Four 64x64 faces (crops of baboon.png): the same GT and degraded
    images from the same seed, draw for draw."""
    faces = tmp_path / 'faces'
    faces.mkdir()
    img = cv2.imread(BABOON)
    for i in range(4):
        cv2.imwrite(str(faces / f'{i:03d}.png'), img[60 * i:60 * i + 64, 50 * i:50 * i + 64])
    for tag in ('port', 'root'):
        argv = ['--input', faces, '--output', tmp_path / tag, '--deg', deg, '--seed', 7]
        if tag == 'port':
            port_hifacegan.main([str(a) for a in argv])
        else:
            run_root(monkeypatch, 'prepare_hifacegan_dataset', argv)
    got = assert_same_tree(tmp_path / 'port', tmp_path / 'root')
    assert sorted(got) == sorted(f'{sub}/{i:03d}.png' for sub in ('gt', f'lq_{deg}')
                                 for i in range(4))
    assert not np.array_equal(got[f'lq_{deg}/001.png'], got['gt/001.png'])


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number, payload):
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def tf_example(img_chw):
    """A ``tf.train.Example`` with ``shape`` (packed Int64List) and ``data``
    (BytesList), as the StyleGAN TFRecords hold them."""
    shape = _field(3, _field(1, b''.join(_varint(v) for v in img_chw.shape)))
    data = _field(1, _field(1, img_chw.tobytes()))
    entries = b''.join(_field(1, _field(1, key.encode()) + _field(2, feature))
                       for key, feature in (('shape', shape), ('data', data)))
    return _field(1, entries)


def write_tfrecord(path, records):
    """TFRecord framing: length, its crc, the data, its crc (the reader
    skips both crcs)."""
    with open(path, 'wb') as f:
        for rec in records:
            f.write(struct.pack('<Q', len(rec)) + b'\0' * 4 + rec + b'\0' * 4)


@pytest.mark.parametrize('save_type', ['img', 'lmdb'])
def test_extract_images_from_tfrecords_matches_root(tmp_path, monkeypatch, save_type):
    """Two files of two 16x16 records each (crops of baboon.png in CHW RGB:
    768 bytes each, so their lengths take two-byte varints), numbered across
    the files in sorted order."""
    img = cv2.imread(BABOON)[:, :, ::-1]
    crops = [np.ascontiguousarray(img[20 * i:20 * i + 16, 30 * i:30 * i + 16].transpose(2, 0, 1))
             for i in range(4)]
    write_tfrecord(tmp_path / 'ffhq-r04-b.tfrecords', [tf_example(c) for c in crops[2:]])
    write_tfrecord(tmp_path / 'ffhq-r04-a.tfrecords', [tf_example(c) for c in crops[:2]])
    parsed = port_tfrecords.parse_example(tf_example(crops[0]))
    assert parsed['shape'] == [3, 16, 16] and parsed['data'] == crops[0].tobytes()
    fake = lmdb_stand_in()
    monkeypatch.setitem(sys.modules, 'lmdb', fake)
    for tag in ('port', 'root'):
        argv = ['--pattern', str(tmp_path / 'ffhq-r04-*.tfrecords'), '--resolution_log2', '4',
                '--output', str(tmp_path / tag), '--save_type', save_type]
        if tag == 'port':
            port_tfrecords.main(argv)
        else:
            run_root(monkeypatch, 'extract_images_from_tfrecords', argv)
    if save_type == 'img':
        got = assert_same_tree(tmp_path / 'port', tmp_path / 'root')
        np.testing.assert_array_equal(got['00000002.png'],
                                      crops[2].transpose(1, 2, 0)[:, :, ::-1])
    else:
        stores = [fake.stores[str(tmp_path / f'{tag}.lmdb')] for tag in ('port', 'root')]
        assert stores[0] == stores[1] and len(stores[0]) == 4
        assert ((tmp_path / 'port.lmdb' / 'meta_info.txt').read_text()
                == (tmp_path / 'root.lmdb' / 'meta_info.txt').read_text()
                == ''.join(f'{i:08d}.png (16,16,3) 1\n' for i in range(4)))
