"""Images from the CelebA / FFHQ TFRecords, into a folder or an LMDB
(counterpart of ``scripts/data_preparation/extract_images_from_tfrecords.py``;
reference: scripts/data_preparation/extract_images_from_tfrecords.py, there on
TensorFlow). The TFRecord framing and the ``tf.train.Example`` protobuf are
parsed by hand, so nothing of TensorFlow is needed.

    python -m basicsr4rs_torch.scripts.data_preparation.extract_images_from_tfrecords \
        --pattern 'datasets/ffhq/tfrecords/ffhq-r08-*.tfrecords' --resolution_log2 8 \
        --output datasets/ffhq_256 [--save_type img|lmdb] [--compress_level 1]

Each record's ``data`` (uint8, shape ``shape`` = (c, h, w), RGB) becomes
``<output>/<index:08d>.png`` in BGR, or the key ``<index:08d>`` of an
``.lmdb`` folder through ``utils.lmdb_util.LmdbMaker``; records are numbered
across the files in sorted order.
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
from os import path as osp

import cv2
import numpy as np

from ...utils.lmdb_util import LmdbMaker


def iter_tfrecord(path):
    """Yield raw record bytes (framing: u64 length, u32 crc, data, u32 crc)."""
    with open(path, 'rb') as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            length, = struct.unpack('<Q', header)
            f.read(4)   # the length's crc
            data = f.read(length)
            f.read(4)   # the data's crc
            yield data


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:     # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:   # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:   # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:   # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, val


def _int64_list(buf):
    """The values of an ``Int64List``, packed or not."""
    vals = []
    for _, wire, value in _iter_fields(buf):
        if wire == 0:
            vals.append(value)
        elif wire == 2:   # packed
            pos = 0
            while pos < len(value):
                x, pos = _read_varint(value, pos)
                vals.append(x)
    return vals


def parse_example(record):
    """A ``tf.train.Example`` as {name: bytes | [bytes] | [int]}."""
    features = {}
    for f1, _, v1 in _iter_fields(record):          # Example.features = 1
        if f1 != 1:
            continue
        for f2, _, entry in _iter_fields(v1):       # the Features map's entries
            if f2 != 1:
                continue
            key, feature = None, None
            for fk, _, vk in _iter_fields(entry):
                if fk == 1:
                    key = vk.decode('utf-8')
                elif fk == 2:
                    feature = vk
            if key is None or feature is None:
                continue
            for ft, _, fv in _iter_fields(feature):
                if ft == 1:     # BytesList
                    values = [v for fb, _, v in _iter_fields(fv) if fb == 1]
                    features[key] = values[0] if len(values) == 1 else values
                elif ft == 3:   # Int64List
                    features[key] = _int64_list(fv)
    return features


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--pattern', required=True, help='tfrecords glob')
    p.add_argument('--resolution_log2', type=int, required=True)
    p.add_argument('--output', required=True)
    p.add_argument('--save_type', choices=['img', 'lmdb'], default='img')
    p.add_argument('--compress_level', type=int, default=1)
    args = p.parse_args(argv)

    res = 2**args.resolution_log2
    if args.save_type == 'lmdb':
        maker = LmdbMaker(args.output if args.output.endswith('.lmdb') else args.output + '.lmdb',
                          compress_level=args.compress_level)
    else:
        os.makedirs(args.output, exist_ok=True)

    idx = 0
    for record_file in sorted(glob.glob(args.pattern)):
        print('Processing record:', record_file, flush=True)
        for record in iter_tfrecord(record_file):
            ex = parse_example(record)
            img = np.frombuffer(ex['data'], np.uint8).reshape(ex['shape'])
            img = img.transpose(1, 2, 0)[:, :, ::-1]   # CHW RGB -> HWC BGR
            if img.shape[0] != res:
                raise ValueError(f'record resolution {img.shape[0]} != {res}')
            key = f'{idx:08d}'
            if args.save_type == 'img':
                cv2.imwrite(osp.join(args.output, f'{key}.png'), img,
                            [cv2.IMWRITE_PNG_COMPRESSION, args.compress_level])
            else:
                _, img_byte = cv2.imencode('.png', img,
                                           [cv2.IMWRITE_PNG_COMPRESSION, args.compress_level])
                maker.put(img_byte, key, img.shape)
            idx += 1
            if idx % 500 == 0:
                print(f'extracted {idx}', flush=True)
    if args.save_type == 'lmdb':
        maker.close()
    print(f'done: {idx} images')


if __name__ == '__main__':
    main()
