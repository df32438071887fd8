"""Read flax's msgpack checkpoints without flax or the ``msgpack`` package.

The JAX package writes a checkpoint as ``flax.serialization.msgpack_serialize``
of its ``TrainState`` (``ssl_cr_histo_tpu/train/checkpoint.py:32-55``).  The
card's machine has neither flax nor ``msgpack``, so this module decodes the
subset of msgpack that flax writes and rebuilds what ``msgpack_restore``
returns (flax 0.12.3 ``serialization.py:237-432``):

- maps (str keys), arrays (as lists), str, bin (as bytes), nil, bool, ints
  of every width, float32 and float64 (as Python floats);
- flax's ext types: ``ndarray`` (1) and ``npscalar`` (3), whose payload is
  itself msgpack of ``(shape, dtype name, C-order bytes)``, and
  ``native_complex`` (2), msgpack of ``(real, imag)``;
- flax's chunked leaves, ``{'__msgpack_chunked_array__': True, 'shape',
  'chunks'}`` maps of arrays larger than its ``MAX_CHUNK_SIZE``, joined
  back into one array.

Array leaves are ``np.frombuffer`` views (read-only) of the bytes read, so
decoding costs one pass over the headers, not over the data.  ``bfloat16``,
which numpy lacks, comes back as a ``torch.bfloat16`` tensor (a copy) with
the same bits.  An unknown dtype or ext type raises, naming it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: first byte -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# first byte -> struct format of the length that follows it
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Decoder:
    """One msgpack document over ``buf``.  With ``raw`` (flax's inner
    ndarray payloads, ``unpackb(..., raw=True)``) str and bin both come back
    as memoryviews of ``buf``; without it str is decoded and bin is bytes."""

    def __init__(self, buf: memoryview, raw: bool):
        self.buf, self.raw, self.pos = buf, raw, 0

    def document(self):
        value = self.value()
        if self.pos != len(self.buf):
            raise ValueError(f"{len(self.buf) - self.pos} bytes after the msgpack document")
        return value

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data truncated: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _STR:
            return self.str(self.unpack(_STR[b]))
        if b in _BIN:
            data = self.take(self.unpack(_BIN[b]))
            return data if self.raw else bytes(data)
        if b in _ARRAY:
            return [self.value() for _ in range(self.unpack(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT or b in _EXT:
            n = _FIXEXT[b] if b in _FIXEXT else self.unpack(_EXT[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack object")

    def str(self, n: int):
        data = self.take(n)
        return data if self.raw else str(data, "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: a view of the payload's bytes as an
    array of its shape and dtype (``bfloat16``: a torch tensor)."""
    shape, name, data = _Decoder(payload, raw=True).document()
    name = bytes(name).decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"an array of dtype {name!r}, which numpy does not know") from None
    return np.frombuffer(data, dtype).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_NATIVE_COMPLEX:
        real, imag = _Decoder(payload, raw=False).document()
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code}, which flax does not write")


def _unchunk(d: dict):
    """flax's ``_unchunk``: the chunks, in order, joined and reshaped."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    """flax's ``_unchunk_array_leaves_in_place``: maps only, not lists."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            tree[k] = _unchunk_leaves(v)
    return tree


def restore(data) -> object:
    """``flax.serialization.msgpack_restore`` of ``data`` (bytes or a
    buffer): the tree of dicts, lists and leaves it encodes."""
    return _unchunk_leaves(_Decoder(memoryview(data).cast("B"), raw=False).document())


def read(path: str) -> object:
    """``restore`` of the file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())
