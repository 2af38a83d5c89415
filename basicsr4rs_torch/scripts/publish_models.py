"""Stamp checkpoints with a short content hash for release (counterpart of
``scripts/publish_models.py``; reference: scripts/publish_models.py).

    python -m basicsr4rs_torch.scripts.publish_models 'experiments/*/models/net_g_*.pth'

Each file or folder the glob names is renamed ``<name>-<8 hex>.<ext>``: the
first eight hex digits of the sha256 over the file's bytes, or over a
folder's files' bytes in sorted walk order.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import os
from os import path as osp


def hash_path(path):
    sha = hashlib.sha256()
    if osp.isdir(path):
        for root, _, files in sorted(os.walk(path)):
            for name in sorted(files):
                with open(osp.join(root, name), 'rb') as f:
                    sha.update(f.read())
    else:
        with open(path, 'rb') as f:
            sha.update(f.read())
    return sha.hexdigest()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('pattern', help='glob of checkpoints to publish')
    args = p.parse_args(argv)
    for path in sorted(glob.glob(args.pattern)):
        base, ext = osp.splitext(path.rstrip('/'))
        new_path = f'{base}-{hash_path(path)[:8]}{ext}'
        os.rename(path, new_path)
        print(f'{path} -> {new_path}')


if __name__ == '__main__':
    main()
