"""A reader of flax msgpack checkpoints that needs nothing beyond numpy and
torch.

``flax.serialization.to_bytes`` writes a state dict (nested dicts with
string keys; tuples and lists become ``{"0": ..., "1": ...}`` dicts) as
msgpack, with three extension types: 1, an ndarray, packed as the msgpack
array ``[shape, dtype name, C-order bytes]``; 2, a Python complex, packed
as ``[real, imag]``; 3, a numpy scalar, packed as a 0-d ndarray.  Arrays
over its chunk size (2**30 bytes) become ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}`` dicts of flat pieces.

``read_flax_msgpack`` decodes that subset of msgpack (maps, strings, bin,
ints, floats, nil, bools, arrays and those extension types) into the tree
flax's ``msgpack_restore`` returns: nested dicts of numpy arrays, numpy
scalars and Python values, chunked arrays joined again, tuple dicts left as
dicts.  numpy has no bfloat16, so a bfloat16 array comes back as a
``torch.bfloat16`` tensor (its bits read as uint16) and a bfloat16 scalar
as a 0-d one.  Any other msgpack type raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:                           # positive fixint
            return b
        if b >= 0xE0:                           # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            return getattr(self, kind)(self.unpack(fmt))
        if 0xD4 <= b <= 0xD8:                   # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                         f"subset flax writes")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).obj()
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not one flax "
                         f"writes")


def _ndarray(data):
    """flax's ndarray encoding, [shape, dtype name, bytes] -> a writable
    array (a torch.bfloat16 tensor for bfloat16)."""
    shape, name, buf = _Reader(data).obj()
    if isinstance(name, bytes):
        name = name.decode()
    dtype = np.uint16 if name == "bfloat16" else np.dtype(name)
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def _tuple(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(d: dict):
    pieces = _tuple(d["chunks"])
    if torch.is_tensor(pieces[0]):
        flat = torch.cat(pieces)
    else:
        flat = np.concatenate(pieces)
    return flat.reshape(tuple(_tuple(d["shape"])))


def _restore(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _restore(v) for k, v in tree.items()}
    return tree


def loads_flax_msgpack(data: bytes):
    """The bytes of ``flax.serialization.to_bytes`` -> the restored tree."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         f"msgpack object")
    return _restore(tree)


def read_flax_msgpack(path: str):
    """A flax ``.msgpack`` checkpoint file -> nested dict of numpy arrays
    (bfloat16 leaves as torch tensors; see the module docstring)."""
    with open(path, "rb") as f:
        return loads_flax_msgpack(f.read())
