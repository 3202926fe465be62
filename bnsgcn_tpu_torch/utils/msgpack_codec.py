"""The msgpack form of a checkpoint payload, as
`flax.serialization.msgpack_serialize` writes it and `msgpack_restore`
reads it, for the types a payload holds. The card's machine has neither
flax nor msgpack, so the port carries this encoder and decoder.

What `packb` writes, byte for byte as flax does (tests pin it against the
installed flax):

  * a tree of dicts (keys sorted, as flax's tree copy sorts them), lists,
    None, bool, int, float (64-bit), str and bytes (a tuple is refused, as
    msgpack's strict_types refuses it);
  * an ndarray as ExtType 1 holding the msgpack of (shape, dtype name, the
    C-order bytes); a numpy scalar as ExtType 3, the same of its 0-d array;
    a `Bfloat16Array` (numpy has no bfloat16 without ml_dtypes) as an
    ndarray of dtype name 'bfloat16', 2 bytes per element, as flax writes a
    bfloat16 leaf, and read back as one;
  * an ndarray above MAX_CHUNK_SIZE bytes as flax's chunked form, a dict
    {'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
    {'0': flat piece, ...}}, which `unpackb` joins back.

Types match exactly (msgpack's strict_types): a numpy float64, a subclass of
float, goes as a numpy scalar. `unpackb` reads every msgpack format, so it
also takes what another encoder chose for the same values.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30               # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"


class Bfloat16Array:
    """A bfloat16 array carried without ml_dtypes: its bits, uint16 in C
    order. torch's bfloat16 tensors map to and from it through a 16-bit
    integer view (trainer.py)."""

    def __init__(self, bits: np.ndarray):
        if bits.dtype != np.uint16:
            raise ValueError(f"bfloat16 bits must be uint16, got {bits.dtype}")
        self.bits = np.ascontiguousarray(bits)

    @property
    def shape(self) -> tuple:
        return self.bits.shape

    def __eq__(self, other) -> bool:
        return (isinstance(other, Bfloat16Array)
                and np.array_equal(self.bits, other.bits)
                and self.bits.shape == other.bits.shape)

    __hash__ = None


# ----------------------------------------------------------------------------
# encoding
# ----------------------------------------------------------------------------

def _sorted_tree(x):
    """A copy of the tree with every dict's keys sorted (what flax's
    `jax.tree_util.tree_map(lambda x: x, tree)` does before packing)."""
    if type(x) is dict:
        return {k: _sorted_tree(x[k]) for k in sorted(x)}
    if type(x) in (list, tuple):
        return type(x)(_sorted_tree(v) for v in x)
    return x


def _index_dict(items) -> dict:
    return {str(i): v for i, v in enumerate(items)}


def _chunk(arr) -> dict:
    """flax's `_chunk`: the array as flat pieces of MAX_CHUNK_SIZE bytes."""
    bf16 = isinstance(arr, Bfloat16Array)
    a = arr.bits if bf16 else arr
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    pieces = (flat[i:i + size] for i in range(0, flat.size, size))
    return {CHUNKED: True, "shape": _index_dict(a.shape),
            "chunks": _index_dict(Bfloat16Array(p) if bf16 else p
                                  for p in pieces)}


def _chunk_leaves(x):
    a = x.bits if isinstance(x, Bfloat16Array) else x
    if (isinstance(a, np.ndarray)
            and a.size * a.dtype.itemsize > MAX_CHUNK_SIZE):
        return _chunk(x)
    if type(x) is dict:
        return {k: _chunk_leaves(v) for k, v in x.items()}
    return x


def _int(x: int, out: bytearray):
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if x < top:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                               (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if x >= low:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack's int64")


def _header(n: int, out: bytearray, fix: int, fix_max: int, codes):
    """A length header: the fix form below fix_max, else the first of
    `codes` ((code, struct format, limit), ...) whose limit n is under."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack object of length {n} is too large")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16), (0xc9, ">I", 1 << 32))


def _ext(code: int, data: bytes, out: bytearray):
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _header(n, out, None, 0, _EXT)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return packb_raw([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(x, out: bytearray):
    t = type(x)
    if x is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if x else 0xc2)
    elif t is int:
        _int(x, out)
    elif t is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif t is str:
        b = x.encode("utf-8")
        _header(len(b), out, 0xa0, 32, _STR)
        out += b
    elif t is bytes:
        _header(len(x), out, None, 0, _BIN)
        out += x
    elif t is list:
        _header(len(x), out, 0x90, 16, _ARR)
        for v in x:
            _pack(v, out)
    elif t is dict:
        _header(len(x), out, 0x80, 16, _MAP)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _ext(EXT_NDARRAY, _ndarray_bytes(x), out)
    elif t is Bfloat16Array:
        _ext(EXT_NDARRAY, packb_raw([list(x.shape), "bfloat16",
                                     x.bits.tobytes("C")]), out)
    elif isinstance(x, np.generic):
        _ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot pack {t.__name__} into a checkpoint")


def packb_raw(x) -> bytes:
    """msgpack of x as it stands (no key sort, no chunking)."""
    out = bytearray()
    _pack(x, out)
    return bytes(out)


def packb(tree) -> bytes:
    """`flax.serialization.msgpack_serialize(tree)`, byte for byte."""
    return packb_raw(_chunk_leaves(_sorted_tree(tree)))


# ----------------------------------------------------------------------------
# decoding
# ----------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            short = self.pos + n - len(self.data)
            raise ValueError(f"msgpack data ends {short} bytes early")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        c = self.num(">B")
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.text(c & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        fmts = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
                0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
        if c in fmts:
            return self.num(fmts[c])
        lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if c in lens:
            return self.text(self.num(lens[c]))
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if c in lens:
            return self.take(self.num(lens[c]))
        if c in (0xdc, 0xdd):
            return self.array(self.num(">H" if c == 0xdc else ">I"))
        if c in (0xde, 0xdf):
            return self.map(self.num(">H" if c == 0xde else ">I"))
        fixext = {v: k for k, v in _FIXEXT.items()}
        if c in fixext:
            n = fixext[c]
        elif c in (0xc7, 0xc8, 0xc9):
            n = self.num({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[c])
        else:
            raise ValueError(f"byte 0x{c:02x} at offset {self.pos - 1} starts "
                             f"no msgpack object")
        code = self.num(">b")
        return _ext_value(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _read_all(data: bytes, raw: bool):
    r = _Reader(data, raw)
    x = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes of extra data after the "
                         f"msgpack object")
    return x


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = _read_all(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return Bfloat16Array(
            np.frombuffer(buf, dtype=np.uint16).reshape(shape).copy())
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_value(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray_from_bytes(data)
        if isinstance(arr, Bfloat16Array):
            raise ValueError("a bfloat16 scalar: numpy has no bfloat16 dtype")
        return arr[()]
    raise ValueError(f"unknown msgpack ExtType {code}")


def _unchunk(x):
    if type(x) is dict:
        if CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            if chunks and isinstance(chunks[0], Bfloat16Array):
                return Bfloat16Array(np.concatenate(
                    [c.bits for c in chunks]).reshape(shape))
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpackb(data: bytes):
    """`flax.serialization.msgpack_restore(data)`: the tree, with ndarrays,
    numpy scalars and chunked arrays joined back."""
    return _unchunk(_read_all(data, raw=False))
