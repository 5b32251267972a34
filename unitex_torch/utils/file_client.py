"""Storage backends for SR dataset reads (port of
unitex_tpu/utils/file_client.py; basicsr's file_client / lmdb_util
semantics).

Images are read straight from disk or from a **packed-record** store, the
JAX package's stand-in for basicsr's LMDB (one sequential file of encoded
images with keyed access):

    name.pkdb/
      data.bin       concatenated encoded images
      index.json     {key: [offset, length, [h, w, c]]}
      meta_info.txt  lines "{key}.png ({h},{w},{c}) {level}", as lmdb_util's

The on-disk format is the JAX package's, so either package reads a store
the other wrote.  ``FileClient("disk" | "packed")`` routes
``get(filepath, client_key)``; 'lmdb' and 'memcached' raise.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .image_io import imtobytes, load_image

_INDEX = "index.json"
_DATA = "data.bin"
_META = "meta_info.txt"


class HardDiskBackend:
    """Raw file reads."""

    def get(self, filepath: str) -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(str(filepath), "r") as f:
            return f.read()


class PackedBackend:
    """Keyed reads from packed-record stores, one store per client key."""

    def __init__(self, db_paths, client_keys="default"):
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, (str, os.PathLike)):
            db_paths = [str(db_paths)]
        if len(client_keys) != len(db_paths):
            raise ValueError(
                "client_keys and db_paths should have the same length, "
                f"but received {len(client_keys)} and {len(db_paths)}.")
        self._stores: Dict[str, Tuple[str, Dict[str, List]]] = {}
        for ck, path in zip(client_keys, db_paths):
            with open(os.path.join(path, _INDEX)) as f:
                self._stores[ck] = (os.path.join(path, _DATA), json.load(f))

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        data_path, index = self._stores[client_key]
        off, length, _shape = index[str(filepath)]
        with open(data_path, "rb") as f:
            f.seek(off)
            return f.read(length)

    def get_text(self, filepath):
        raise NotImplementedError("a packed store holds no text files")

    def keys(self, client_key: str = "default") -> List[str]:
        return list(self._stores[client_key][1].keys())

    def shape(self, key: str, client_key: str = "default") -> Tuple[int, ...]:
        return tuple(self._stores[client_key][1][str(key)][2])


class FileClient:
    """Front end dispatching to a storage backend."""

    _backends = {"disk": HardDiskBackend, "packed": PackedBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend in ("lmdb", "memcached"):
            raise ValueError(
                f"backend {backend!r} needs an external client library; "
                "use 'packed' (same keyed-store capability) or 'disk'.")
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} is not supported. Currently supported "
                f"ones are {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if self.backend == "packed":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)


class PackedMaker:
    """Incremental packed-store writer: ``put(img_byte, key, img_shape)``,
    then ``close()`` writes the index and the meta file."""

    def __init__(self, path: str, compress_level: int = 1):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.compress_level = compress_level
        self._data = open(os.path.join(path, _DATA), "wb")
        self._index: Dict[str, List] = {}
        self._offset = 0

    def put(self, img_byte: bytes, key: str, img_shape: Sequence[int]):
        self._index[str(key)] = [self._offset, len(img_byte),
                                 list(img_shape)]
        self._data.write(img_byte)
        self._offset += len(img_byte)

    def close(self):
        self._data.close()
        with open(os.path.join(self.path, _INDEX), "w") as f:
            json.dump(self._index, f)
        with open(os.path.join(self.path, _META), "w") as f:
            for key, (_o, _l, (h, w, c)) in self._index.items():
                f.write(f"{key}.png ({h},{w},{c}) {self.compress_level}\n")


def make_packed_from_imgs(
    data_path: str,
    pack_path: str,
    img_path_list: Sequence[str],
    keys: Optional[Sequence[str]] = None,
    compress_level: int = 1,
) -> str:
    """Pack the images ``img_path_list`` (relative to ``data_path``) into
    a store at ``pack_path``, re-encoded as PNG; keys default to the
    extension-stripped relative paths."""
    if keys is None:
        keys = [os.path.splitext(p)[0] for p in img_path_list]
    if len(keys) != len(img_path_list):
        raise ValueError(f"{len(keys)} keys for {len(img_path_list)} images")
    maker = PackedMaker(pack_path, compress_level)
    for rel, key in zip(img_path_list, keys):
        img = load_image(os.path.join(data_path, rel))
        maker.put(imtobytes(img, compress_level=compress_level), key,
                  (img.shape[0], img.shape[1], img.shape[2]))
    maker.close()
    return pack_path


def paths_from_meta_info(pack_path: str) -> List[str]:
    """The keys a store's meta_info.txt lists, in its order."""
    with open(os.path.join(pack_path, _META)) as f:
        return [line.split(" ")[0].rsplit(".", 1)[0]
                for line in f if line.strip()]


def scandir(dir_path: str, suffix: Optional[str] = None,
            recursive: bool = False, full_path: bool = False):
    """Generator over the files under ``dir_path`` in sorted order (hidden
    ones skipped), relative to it unless ``full_path``."""
    if suffix is not None and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scan(d):
        for entry in sorted(os.scandir(d), key=lambda e: e.path):
            if not entry.name.startswith(".") and entry.is_file():
                rv = entry.path if full_path else os.path.relpath(
                    entry.path, root)
                if suffix is None or rv.endswith(suffix):
                    yield rv
            elif recursive and entry.is_dir(follow_symlinks=False):
                yield from _scan(entry.path)

    return _scan(dir_path)
