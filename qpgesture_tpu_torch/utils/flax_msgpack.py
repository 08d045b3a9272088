"""Read and write the msgpack files of ``flax.serialization``.

The JAX package writes its VQ-VAE checkpoints (``save_vqvae_native``) and
the payload of its FGD extractor files with ``flax.serialization.to_bytes``:
msgpack of the parameter tree's state dict, each ndarray an ext of type 1
whose data is itself msgpack of ``(shape, dtype name, raw C-order
buffer)``, numpy scalars an ext of type 3 of the same form, Python complex
numbers an ext of type 2 of ``(real, imag)``, and arrays above 2**30 bytes
split into ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks":
...}``. flax stores a list or tuple as a map with keys ``"0"``, ``"1"``,
...; ``unpack`` returns such maps as they are, as flax's
``msgpack_restore`` does, and the converters index them by those keys.

This module has no dependency on the ``msgpack`` package (the port runs
where it is not installed). ``unpack`` returns nested dicts of numpy
arrays (bfloat16 arrays widened exactly to float32) and raises
``ValueError`` on malformed or truncated input. ``pack`` writes the bytes
``flax.serialization.to_bytes`` writes for a tree of dicts, ndarrays and
Python scalars.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at "
                             f"offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width headers: byte -> (struct format, kind)
_FIXED = {0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q",
          0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q",
          0xca: "f", 0xcb: "d"}
_LEN = {0xc4: ("B", "bin"), 0xc5: ("H", "bin"), 0xc6: ("I", "bin"),
        0xd9: ("B", "str"), 0xda: ("H", "str"), 0xdb: ("I", "str"),
        0xdc: ("H", "array"), 0xdd: ("I", "array"),
        0xde: ("H", "map"), 0xdf: ("I", "map"),
        0xc7: ("B", "ext"), 0xc8: ("H", "ext"), 0xc9: ("I", "ext")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _read(r: _Reader, raw_str: bool = False) -> Any:
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r, raw_str) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r.take(b & 0x1f), raw_str)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _FIXED:
        return r.num(_FIXED[b])
    if b in _FIXEXT:
        code = r.num("b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _LEN:
        fmt, kind = _LEN[b]
        n = r.num(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return _str(r.take(n), raw_str)
        if kind == "array":
            return [_read(r, raw_str) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.num("b")
        return _ext(code, r.take(n))
    raise ValueError(f"invalid msgpack byte 0x{b:02x} at offset "
                     f"{r.pos - 1}")


def _str(b: bytes, raw: bool):
    if raw:
        return b
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"msgpack str is not UTF-8: {e}") from None


def _read_map(r: _Reader, n: int) -> Dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        try:
            out[key] = _read(r)
        except TypeError:
            raise ValueError(f"unhashable msgpack map key {key!r}") from None
    return out


def _one(data: bytes, raw_str: bool = False) -> Any:
    r = _Reader(data)
    out = _read(r, raw_str)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    obj = _one(data, raw_str=True)
    if not (isinstance(obj, list) and len(obj) == 3
            and isinstance(obj[0], list) and isinstance(obj[2], bytes)):
        raise ValueError("flax ndarray ext is not (shape, dtype, buffer)")
    shape, name, buf = obj
    name = name.decode() if isinstance(name, bytes) else str(name)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        flat = bits.view(np.float32)
    else:
        try:
            flat = np.frombuffer(buf, np.dtype(name))
        except (TypeError, ValueError) as e:
            raise ValueError(f"flax ndarray ext: {e}") from None
    if flat.size != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"flax ndarray ext: {flat.size} elements for "
                         f"shape {tuple(shape)}")
    return flat.reshape(shape).copy()       # writable, off the buffer


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        re_im = _one(data)
        if not (isinstance(re_im, list) and len(re_im) == 2):
            raise ValueError("flax complex ext is not (real, imag)")
        return complex(re_im[0], re_im[1])
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            try:
                shape = tuple(tree["shape"][str(i)]
                              for i in range(len(tree["shape"])))
                chunks = [tree["chunks"][str(i)]
                          for i in range(len(tree["chunks"]))]
                return np.concatenate(chunks).reshape(shape)
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"malformed chunked array: {e!r}") from None
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpack(data: bytes) -> Any:
    """The tree that ``flax.serialization.to_bytes`` wrote: nested dicts
    with numpy array (and Python scalar) leaves."""
    return _unchunk(_one(bytes(data)))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return unpack(f.read())


# -- writing ---------------------------------------------------------------

def _head(out: bytearray, n: int, fix: Tuple[int, int], wide) -> None:
    """Header of a str / bin / array / map of length n: the fix form
    (first byte, largest n) if it has one, else the narrowest width."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for byte, fmt in wide:
        if n < (1 << (8 * struct.calcsize(fmt))):
            out.append(byte)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7f:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for byte, fmt in ((0xcc, "B"), (0xcd, "H"), (0xce, "I"),
                          (0xcf, "Q")):
            if v < (1 << (8 * struct.calcsize(fmt))):
                out.append(byte)
                out += struct.pack(">" + fmt, v)
                return
        raise ValueError(f"int {v} too large for msgpack")
    else:
        for byte, fmt in ((0xd0, "b"), (0xd1, "h"), (0xd2, "i"),
                          (0xd3, "q")):
            bits = 8 * struct.calcsize(fmt)
            if v >= -(1 << (bits - 1)):
                out.append(byte)
                out += struct.pack(">" + fmt, v)
                return
        raise ValueError(f"int {v} too small for msgpack")


def _ext_bytes(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _head(out, len(data), None, ((0xc7, "B"), (0xc8, "H"), (0xc9, "I")))
    out += struct.pack(">b", code)
    out += data


def _write(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xc0)
    elif isinstance(v, bool):
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(0xcb)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), (0xa0, 31), ((0xd9, "B"), (0xda, "H"),
                                        (0xdb, "I")))
        out += b
    elif isinstance(v, bytes):
        _head(out, len(v), None, ((0xc4, "B"), (0xc5, "H"), (0xc6, "I")))
        out += v
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), (0x90, 15), ((0xdc, "H"), (0xdd, "I")))
        for x in v:
            _write(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), (0x80, 15), ((0xde, "H"), (0xdf, "I")))
        for k, x in v.items():
            _write(out, k)
            _write(out, x)
    elif isinstance(v, np.ndarray):
        _ext_bytes(out, EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _ext_bytes(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    else:
        raise ValueError(f"cannot write {type(v).__name__} as flax msgpack")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not written")
    out = bytearray()
    _write(out, [list(a.shape), a.dtype.name, a.tobytes("C")])
    return bytes(out)


def pack(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree`` (dicts
    with str keys, numpy arrays, numpy and Python scalars). Arrays above
    flax's 2**30-byte chunk size are refused rather than chunked."""
    def check(t):
        if isinstance(t, dict):
            for x in t.values():
                check(x)
        elif isinstance(t, np.ndarray) and t.nbytes > (1 << 30):
            raise ValueError("arrays above 2**30 bytes are not written")
    check(tree)
    out = bytearray()
    _write(out, tree)
    return bytes(out)


def save(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(pack(tree))
