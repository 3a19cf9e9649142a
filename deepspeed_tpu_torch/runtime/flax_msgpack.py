"""The msgpack encoding of the checkpoint files, in pure Python over
numpy and torch: the subset of ``flax.serialization``'s
``msgpack_serialize`` / ``msgpack_restore`` that the JAX package's
checkpoints use (``deepspeed_tpu/runtime/engine.py``: the model file
``{"module": params}``, the optimizer shard files and their
``__scalars__``). The port carries its own codec because neither flax
nor ``msgpack`` is a dependency of the port.

What it writes is byte for byte what flax writes for the same tree:

- maps (string keys, sorted at every level, the order JAX's tree map
  gives), strings, ints (the smallest msgpack int that holds the
  value), floats (float64), bools, nil, lists;
- arrays (numpy, or torch tensors on any device) as msgpack ext type 1,
  and numpy scalars as ext type 3; the ext payload is the msgpack array
  ``[shape, dtype name, C-order bytes]``;
- a dict value (or the top level) of more than ``MAX_CHUNK_SIZE`` bytes
  as flax's chunked form ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ...}, "chunks": {"0": flat chunk, ...}}``.

``msgpack_restore`` reads the same subset back (and every msgpack
scalar and container type). Arrays come back as read-only numpy arrays
that share the input's memory, except ``bfloat16`` ones: numpy has no
bfloat16 without ml_dtypes, so those come back as ``torch.bfloat16``
tensors, decoded through a 2-byte integer view.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are chunked
# (msgpack's own limit is 2**31 - 1 bytes an object).
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"

ArrayLike = Union[np.ndarray, torch.Tensor]


# --------------------------------------------------------------------- #
# Encoding
# --------------------------------------------------------------------- #
def _head(n: int, small: int, small_max: int, b8: int, b16: int,
          b32: int) -> bytes:
    """A str/bin/array/map header: a fix form up to ``small_max`` (when
    there is one), else the 8-, 16- or 32-bit length form."""
    if small >= 0 and n <= small_max:
        return bytes((small | n,))
    if b8 >= 0 and n < 0x100:
        return bytes((b8, n))
    if n < 0x10000:
        return struct.pack(">BH", b16, n)
    return struct.pack(">BI", b32, n)


def _str_head(n: int) -> bytes:
    return _head(n, 0xA0, 31, 0xD9, 0xDA, 0xDB)


def _bin_head(n: int) -> bytes:
    return _head(n, -1, -1, 0xC4, 0xC5, 0xC6)


def _array_head(n: int) -> bytes:
    return _head(n, 0x90, 15, -1, 0xDC, 0xDD)


def _map_head(n: int) -> bytes:
    return _head(n, 0x80, 15, -1, 0xDE, 0xDF)


def _ext_head(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    if n < 0x100:
        return bytes((0xC7, n, code))
    if n < 0x10000:
        return struct.pack(">BHB", 0xC8, n, code)
    return struct.pack(">BIB", 0xC9, n, code)


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -0x20 <= x < 0:
        return struct.pack("b", x)
    if 0x80 <= x <= 0xFF:
        return struct.pack(">BB", 0xCC, x)
    if -0x80 <= x < 0:
        return struct.pack(">Bb", 0xD0, x)
    if 0xFF < x <= 0xFFFF:
        return struct.pack(">BH", 0xCD, x)
    if -0x8000 <= x < -0x80:
        return struct.pack(">Bh", 0xD1, x)
    if 0xFFFF < x <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, x)
    if -0x80000000 <= x < -0x8000:
        return struct.pack(">Bi", 0xD2, x)
    if 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, x)
    if -0x8000000000000000 <= x < -0x80000000:
        return struct.pack(">Bq", 0xD3, x)
    raise OverflowError(f"int {x} does not fit a msgpack integer")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _str_head(len(b)) + b


def _dtype_name(x: ArrayLike) -> str:
    """The numpy dtype name flax records (``bfloat16`` for bf16)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return x.dtype.name


def _shape_and_bytes(x: ArrayLike) -> Tuple[Tuple[int, ...], Any]:
    """The array's shape and its C-order bytes (a buffer, not a copy,
    where the array is contiguous on the host)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        shape = tuple(int(d) for d in t.shape)
        return shape, t.contiguous().reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)
    shape = tuple(int(d) for d in a.shape)
    # (np.ascontiguousarray would make a 0-d array 1-d)
    return shape, np.ascontiguousarray(a.reshape(-1)).view(np.uint8)


def _nbytes(x: ArrayLike) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.size) * x.dtype.itemsize


def _ext_array(x: ArrayLike, code: int, out: List[Any]) -> None:
    shape, raw = _shape_and_bytes(x)
    inner = b"".join([bytes((0x93,)), _array_head(len(shape)),
                      *[_int(d) for d in shape], _str(_dtype_name(x)),
                      _bin_head(len(raw))])
    out.append(_ext_head(len(inner) + len(raw), code))
    out.append(inner)
    out.append(raw)


def _chunk(x: ArrayLike) -> Dict[str, Any]:
    """flax's ``_chunk``: the flat array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    item = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = x.reshape(-1)
    n = int(flat.shape[0])
    return {CHUNKED_KEY: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pack(x: Any, out: List[Any], sort_keys: bool = True) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        out.append(_str(x))
    elif isinstance(x, dict):
        out.append(_map_head(len(x)))
        keys = sorted(x) if sort_keys else list(x)
        for k in keys:
            if not isinstance(k, str):
                raise TypeError(f"map keys must be strings, got {k!r}")
            out.append(_str(k))
            v = x[k]
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                # The chunked form keeps flax's insertion order.
                _pack(_chunk(v), out, sort_keys=False)
            else:
                _pack(v, out, sort_keys)
    elif isinstance(x, list):
        out.append(_array_head(len(x)))
        for v in x:
            _pack(v, out, sort_keys)
    elif _is_array(x):
        _ext_array(x, EXT_NDARRAY, out)
    elif isinstance(x, np.generic):
        _ext_array(np.asarray(x), EXT_NPSCALAR, out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} "
                        "(the checkpoint codec takes dicts, lists, "
                        "scalars, numpy arrays and torch tensors)")


def msgpack_serialize(tree: Any) -> bytes:
    """``tree`` → the bytes ``flax.serialization.msgpack_serialize``
    gives for the same tree (torch tensors count as arrays)."""
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
        out: List[Any] = []
        _pack(tree, out, sort_keys=False)
    else:
        out = []
        _pack(tree, out)
    return b"".join(out)


# --------------------------------------------------------------------- #
# Decoding
# --------------------------------------------------------------------- #
def _array_from_payload(payload: memoryview):
    (shape, name, raw), _ = _Reader(payload).read_at(0)
    shape = tuple(shape)
    if name == "bfloat16":
        u16 = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(u16).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    """A recursive msgpack decoder over a memoryview (bin payloads stay
    views of the input)."""

    def __init__(self, buf: memoryview):
        self.buf = buf

    def _u(self, fmt: str, at: int):
        return struct.unpack_from(fmt, self.buf, at)[0]

    def read_at(self, at: int) -> Tuple[Any, int]:
        b = self.buf[at]
        at += 1
        if b <= 0x7F:
            return b, at
        if b >= 0xE0:
            return b - 0x100, at
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return self._list(b & 0x0F, at)
        if 0xA0 <= b <= 0xBF:
            return self._text(b & 0x1F, at)
        if b == 0xC0:
            return None, at
        if b == 0xC2:
            return False, at
        if b == 0xC3:
            return True, at
        if b in (0xC4, 0xC5, 0xC6):
            fmt, w = {0xC4: (">B", 1), 0xC5: (">H", 2),
                      0xC6: (">I", 4)}[b]
            n = self._u(fmt, at)
            at += w
            return self.buf[at:at + n], at + n
        if b in (0xC7, 0xC8, 0xC9):
            fmt, w = {0xC7: (">B", 1), 0xC8: (">H", 2),
                      0xC9: (">I", 4)}[b]
            n = self._u(fmt, at)
            return self._ext(n, at + w)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4), at)
        if b == 0xCA:
            return self._u(">f", at), at + 4
        if b == 0xCB:
            return self._u(">d", at), at + 8
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
                0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
                0xD2: (">i", 4), 0xD3: (">q", 8)}
        if b in ints:
            fmt, w = ints[b]
            return self._u(fmt, at), at + w
        if b in (0xD9, 0xDA, 0xDB):
            fmt, w = {0xD9: (">B", 1), 0xDA: (">H", 2),
                      0xDB: (">I", 4)}[b]
            return self._text(self._u(fmt, at), at + w)
        if b in (0xDC, 0xDD):
            fmt, w = (">H", 2) if b == 0xDC else (">I", 4)
            return self._list(self._u(fmt, at), at + w)
        if b in (0xDE, 0xDF):
            fmt, w = (">H", 2) if b == 0xDE else (">I", 4)
            return self._map(self._u(fmt, at), at + w)
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at {at - 1}")

    def _text(self, n: int, at: int) -> Tuple[str, int]:
        return bytes(self.buf[at:at + n]).decode("utf-8"), at + n

    def _list(self, n: int, at: int) -> Tuple[List[Any], int]:
        out = []
        for _ in range(n):
            v, at = self.read_at(at)
            out.append(v)
        return out, at

    def _map(self, n: int, at: int) -> Tuple[Dict[Any, Any], int]:
        out = {}
        for _ in range(n):
            k, at = self.read_at(at)
            v, at = self.read_at(at)
            out[k] = v
        return out, at

    def _ext(self, n: int, at: int) -> Tuple[Any, int]:
        code = self._u(">b", at)
        payload = self.buf[at + 1:at + 1 + n]
        end = at + 1 + n
        if code == EXT_NDARRAY:
            return _array_from_payload(payload), end
        if code == EXT_NPSCALAR:
            a = _array_from_payload(payload)
            return (a if isinstance(a, torch.Tensor) else a[()]), end
        raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x: Any) -> Any:
    if isinstance(x, dict):
        if CHUNKED_KEY in x:
            return _unchunk(x)
        for k, v in x.items():
            if isinstance(v, dict):
                x[k] = _unchunk_tree(v)
    return x


def msgpack_restore(data: Union[bytes, bytearray, memoryview]) -> Any:
    """Bytes written by flax's ``msgpack_serialize`` (or by
    ``msgpack_serialize`` above) → the tree, chunked arrays joined."""
    buf = memoryview(data).cast("B")
    tree, end = _Reader(buf).read_at(0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the "
                         "msgpack object")
    return _unchunk_tree(tree)


__all__ = ["MAX_CHUNK_SIZE", "msgpack_serialize", "msgpack_restore"]
