"""The JAX package's flax checkpoints without flax or msgpack.

multitalent_tpu/training/trainer_base.py:166-182 writes `<name>.ckpt` with
`flax.serialization.to_bytes({"step", "params"[, "opt_state"]})`: msgpack of
nested string-keyed maps whose leaves are numpy arrays in flax's ext types.
This module decodes and encodes that subset itself:

- msgpack: nil, bool, int and uint of every width, float32/64, str, bin,
  array, map and ext in all their fixed and sized forms (big-endian);
- ext 1, an ndarray: msgpack of `(shape, dtype name, C-order buffer)`;
  ext 3, a numpy scalar, packed the same way;
- flax's chunked leaves, `{"__msgpack_chunked_array__": True, "shape":
  {"0": ...}, "chunks": {"0": ...}}`, for arrays over MAX_CHUNK_SIZE bytes;
- bfloat16 leaves, which numpy cannot name, become `torch.bfloat16`
  tensors (their bits read as uint16).

`loads` returns the nested dict (`"step"`, `"params"`, `"opt_state"` where
saved) with numpy leaves; `dumps` writes the bytes `to_bytes` writes for a
tree of dicts and numpy arrays, so a JAX-layout folder can be made where
there is no JAX.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: leaves over this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30


class _Reader:
    """A msgpack decoder over one buffer; `raw` keeps str as bytes (flax
    unpacks an ndarray's inner tuple with raw=True)."""

    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_value(code, self.take(n))

    def value(self):
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sized:
            return bytes(self.take(self.unpack(sized[t])))
        if t in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not in the subset flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(data) -> np.ndarray | torch.Tensor:
    r = _Reader(data, raw=True)
    shape, name, buffer = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes in an ndarray ext")
    shape = tuple(int(s) for s in shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(name.decode())).reshape(shape).copy()


def _ext_value(code: int, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack ext type {code} is not an array or a numpy scalar")


def _unchunk(tree):
    """Chunked leaves back into arrays (flax's _unchunk_array_leaves_in_place)."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes):
    """flax.serialization.msgpack_restore of `data`, without flax."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load(path: str):
    """The tree of a `.ckpt` file."""
    with open(path, "rb") as f:
        return loads(f.read())


# ------------------------------------------------------------------- encoder
def _header(out: list, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fixed form where it fits, else the smallest of
    the 8/16/32-bit forms `codes` (None where a type has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack("b" if v < 0 else "B", v))
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xD0, ">b", -0x80, -1), (0xCD, ">H", 0, 0xFFFF),
             (0xD1, ">h", -0x8000, -1), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xD2, ">i", -0x80000000, -1), (0xCF, ">Q", 0, 2 ** 64 - 1),
             (0xD3, ">q", -2 ** 63, -1))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(bytes([code]) + struct.pack(fmt, v))
            return
    raise OverflowError(f"integer {v} does not fit msgpack")


def _ext(out: list, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(bytes([fixed[len(data)]]))
    else:
        _header(out, len(data), None, -1, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", code))
    out.append(data)


def _array_bytes(arr: np.ndarray, name: str) -> bytes:
    """flax's _ndarray_to_bytes: msgpack of (shape, dtype name, buffer)."""
    out: list = []
    _header(out, 3, 0x90, 15, (None, 0xDC, 0xDD))
    _header(out, len(arr.shape), 0x90, 15, (None, 0xDC, 0xDD))
    for s in arr.shape:
        _int(out, int(s))
    _pack(out, name)
    _pack(out, arr.tobytes("C"))
    return b"".join(out)


def _leaf(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.detach().cpu().contiguous().view(torch.uint16).numpy(), "bfloat16"
        x = x.detach().cpu().numpy()
    if x.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16, where it is installed
        return x.view(np.uint16), "bfloat16"
    return x, x.dtype.name


def _chunk(arr, name: str) -> dict:
    """flax's _chunk: a flat array cut into chunks of MAX_CHUNK_SIZE bytes."""
    flat = arr.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    if name == "bfloat16":
        chunks = [torch.from_numpy(c.copy()).view(torch.bfloat16) for c in chunks]
    return {CHUNKED: True, "shape": {str(i): s for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: list, x) -> None:
    # numpy first: np.float64 subclasses float, and flax packs it (strict
    # types) as a numpy scalar
    if isinstance(x, (np.ndarray, torch.Tensor)):
        arr, name = _leaf(x)
        if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(arr, name))
        else:
            _ext(out, EXT_NDARRAY, _array_bytes(arr, name))
    elif isinstance(x, np.generic):
        arr = np.asarray(x)
        _ext(out, EXT_NPSCALAR, _array_bytes(arr, arr.dtype.name))
    elif x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _header(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif isinstance(x, (bytes, bytearray)):
        _header(out, len(x), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
    elif isinstance(x, (list, tuple)):
        # flax.serialization.to_state_dict makes a sequence a map by index
        _pack(out, {str(i): v for i, v in enumerate(x)})
    elif isinstance(x, dict):
        _header(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot encode {type(x).__name__} as flax msgpack")


def dumps(tree) -> bytes:
    """The bytes flax.serialization.to_bytes writes for `tree`: nested dicts
    (keys in their order; lists and tuples as maps by index, as flax's state
    dicts have them) of numpy arrays, numpy scalars, torch tensors (bfloat16
    ones as flax's bfloat16 leaves) and python scalars."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


def save(path: str, tree) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))
