"""Read the JAX package's checkpoints: flax msgpack files, without flax.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``
(``mindpose_tpu/utils/checkpoint.py:50-55``) and reads them with
``msgpack_restore`` (:27-41). The port can import neither flax (it imports
JAX) nor count on the ``msgpack`` package, so this module decodes the subset
of msgpack that flax writes with ``struct`` alone: maps, arrays, str, bin,
ints, floats, nil, bools, and flax's three ext types:

- code 1, ndarray: a nested msgpack of (shape, dtype name, row-major bytes);
- code 2, native complex: a nested msgpack of (real, imag);
- code 3, npscalar: an ndarray of shape () unpacked to its scalar.

Arrays come out as read-only numpy arrays, as flax gives them, except
``bfloat16``: numpy has no such type, so such a leaf is a ``torch.bfloat16``
tensor built from its raw bytes. Chunked large arrays
(``__msgpack_chunked_array__``) are joined back as flax joins them.
"""
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["msgpack_restore", "load_variables"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# first byte -> (struct format of the fixed-size payload, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# first byte -> size in bytes of the length field that follows it
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """One pass over a msgpack buffer. ``raw``: str comes out as bytes."""

    def __init__(self, data: bytes, raw: bool) -> None:
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return struct.unpack(_UINT[size], self.take(size))[0]

    def str_(self, n: int) -> Any:
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        return _ext(code, bytes(self.take(n)))

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _STR:
            return self.str_(self.uint(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _ARRAY:
            return self.array(self.uint(_ARRAY[b]))
        if b in _MAP:
            return self.map_(self.uint(_MAP[b]))
        if b in _EXT:
            return self.ext(self.uint(_EXT[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one that flax writes")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpack(data: bytes, raw: bool) -> Any:
    reader = _Reader(data, raw)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of msgpack data after the object")
    return out


def _ndarray(data: bytes) -> Any:
    """flax's ``_ndarray_from_bytes``; a bfloat16 array becomes a torch tensor."""
    shape, dtype_name, buffer = _unpack(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        if not buffer:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()), count=-1,
                         offset=0).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = _unpack(data, raw=False)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def _dict_to_tuple(d: Dict[str, Any]) -> Tuple[Any, ...]:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: Dict[str, Any]) -> Any:
    shape = _dict_to_tuple(d["shape"])
    chunks = _dict_to_tuple(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: dicts are walked, lists not."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_in_place(v)
    return d


def msgpack_restore(encoded: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``encoded``."""
    return _unchunk_in_place(_unpack(encoded, raw=False))


def load_variables(path: str) -> Dict[str, Any]:
    """A JAX package checkpoint -> ``{"params", "batch_stats"}``.

    Counterpart of ``mindpose_tpu/utils/checkpoint.py:load_variables``. The
    file is a full saved TrainState or a raw params tree; a tree without
    ``batch_stats`` gives an empty one. The result feeds
    ``models/convert.convert_net_variables``.
    """
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    return {"params": raw.get("params", raw), "batch_stats": raw.get("batch_stats", {})}
