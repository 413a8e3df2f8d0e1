"""MindSpore .ckpt reader and writer, in numpy, with no MindSpore.

A copy of ``mindpose_tpu/utils/ms_ckpt.py`` (``read_ms_checkpoint`` :103,
``write_ms_checkpoint`` :141), which the port's ``tools/convert_ckpt.py`` reads
published backbones with; tests/test_torch_host_copies.py pins it to the
original. A .ckpt is a protobuf message:

    message Checkpoint {
      message Value { required string tag = 1; required TensorProto tensor = 2; }
      repeated Value value = 1;
    }
    message TensorProto {
      repeated int64 dims = 1;
      required string tensor_type = 2;
      required bytes tensor_content = 3;
    }

read and written here by hand (varint framing). The writer serves round
trips in the tests and exports to the MindSpore ecosystem.
"""
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["read_ms_checkpoint", "write_ms_checkpoint"]

_DTYPES = {
    "Float64": np.float64,
    "Float32": np.float32,
    "Float16": np.float16,
    "Int64": np.int64,
    "Int32": np.int32,
    "Int16": np.int16,
    "Int8": np.int8,
    "UInt8": np.uint8,
    "Bool": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long — not a MindSpore checkpoint?")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> np.ndarray:
    dims: List[int] = []
    dtype_name = "Float32"
    content = b""
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims (repeated int64; accept packed or unpacked)
            if wire == 0:
                dims.append(int(val))
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    dims.append(int(d))
        elif field == 2:
            dtype_name = bytes(val).decode("utf-8")
        elif field == 3:
            content = bytes(val)
    if dtype_name not in _DTYPES:
        raise ValueError(f"unsupported MindSpore tensor_type {dtype_name!r}")
    arr = np.frombuffer(content, dtype=_DTYPES[dtype_name])
    return arr.reshape(dims) if dims else arr.reshape(())


def read_ms_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Parse a MindSpore .ckpt into {parameter_name: ndarray}."""
    with open(path, "rb") as f:
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, _wire, val in _iter_fields(buf):
        if field != 1:
            continue
        tag = None
        tensor = None
        for f2, _w2, v2 in _iter_fields(val):
            if f2 == 1:
                tag = bytes(v2).decode("utf-8")
            elif f2 == 2:
                tensor = _parse_tensor(v2)
        if tag is not None and tensor is not None:
            out[tag] = tensor
    if not out:
        raise ValueError(f"no tensors found in {path!r} — not a .ckpt file?")
    return out


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def write_ms_checkpoint(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Serialize {name: ndarray} in MindSpore .ckpt wire format."""
    body = bytearray()
    for tag, arr in tensors.items():
        arr = np.asarray(arr)
        dtype_name = _DTYPE_NAMES.get(arr.dtype)
        if dtype_name is None:
            raise ValueError(f"unsupported dtype {arr.dtype} for {tag!r}")
        tensor = bytearray()
        for d in arr.shape:
            tensor += _varint(1 << 3) + _varint(d)  # dims, unpacked varints
        tensor += _ld_field(2, dtype_name.encode("utf-8"))
        tensor += _ld_field(3, np.ascontiguousarray(arr).tobytes())
        value = _ld_field(1, tag.encode("utf-8")) + _ld_field(2, bytes(tensor))
        body += _ld_field(1, bytes(value))
    with open(path, "wb") as f:
        f.write(bytes(body))
