"""Byte-store backends (counterpart of ``basicsr4rs_tpu/utils/file_client.py``;
reference: basicsr/utils/file_client.py). The disk backend is ported; the
LMDB and memcached backends come with the datasets that use them."""

from __future__ import annotations


class HardDiskBackend:
    """Raw filesystem backend."""

    def get(self, filepath: str) -> bytes:
        with open(str(filepath), 'rb') as f:
            return f.read()


class FileClient:
    """Facade over a named backend."""

    _backends = {'disk': HardDiskBackend}

    def __init__(self, backend: str = 'disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(f'Backend {backend} is not supported. '
                             f'Currently supported ones are {list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = 'default') -> bytes:
        return self.client.get(filepath)
