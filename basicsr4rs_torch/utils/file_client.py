"""Byte-store backends (counterpart of ``basicsr4rs_tpu/utils/file_client.py``;
reference: basicsr/utils/file_client.py). The disk backend, and the LMDB
backend behind the ``lmdb`` import, as in the JAX package; the memcached
backend is not ported."""

from __future__ import annotations


class HardDiskBackend:
    """Raw filesystem backend."""

    def get(self, filepath: str) -> bytes:
        with open(str(filepath), 'rb') as f:
            return f.read()


class LmdbBackend:
    """Read-only LMDB environments, one a client key. ``lmdb`` is imported and
    the environments are opened at the first ``get``, so that making the
    backend (and a dataset) needs no ``lmdb`` and each loader worker opens its
    own; without ``lmdb`` the first ``get`` raises ``ImportError``."""

    def __init__(self, db_paths, client_keys='default', readonly: bool = True,
                 lock: bool = False, readahead: bool = False, **kwargs):
        client_keys = [client_keys] if isinstance(client_keys, str) else list(client_keys)
        db_paths = [str(v) for v in db_paths] if isinstance(db_paths, list) else [str(db_paths)]
        if len(client_keys) != len(db_paths):
            raise ValueError('client_keys and db_paths should have the same length, '
                             f'but received {len(client_keys)} and {len(db_paths)}.')
        self.db_paths = dict(zip(client_keys, db_paths))
        self._open_kwargs = dict(readonly=readonly, lock=lock, readahead=readahead, **kwargs)
        self._envs = None

    def get(self, filepath: str, client_key: str = 'default') -> bytes:
        if client_key not in self.db_paths:
            raise KeyError(f'client_key {client_key} is not in lmdb clients.')
        if self._envs is None:
            try:
                import lmdb
            except ImportError:
                raise ImportError('Please install lmdb to enable LmdbBackend.')
            self._envs = {key: lmdb.open(path, **self._open_kwargs)
                          for key, path in self.db_paths.items()}
        with self._envs[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode('ascii'))


class FileClient:
    """Facade over a named backend."""

    _backends = {'disk': HardDiskBackend, 'lmdb': LmdbBackend}

    def __init__(self, backend: str = 'disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(f'Backend {backend} is not supported. '
                             f'Currently supported ones are {list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = 'default') -> bytes:
        if self.backend == 'lmdb':
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)
