"""msgpack tree checkpointer, byte for byte the reference's format.

The port of ``repro.checkpoint.checkpointer``.  Arrays are written as
(dtype, shape, raw bytes); the tree as string-keyed maps, sequences and
namedtuple names, exactly as the reference's ``_encode`` lays them out:
dict keys in sorted order (the order ``jax.tree.map`` leaves them in),
every leaf but ``None`` as an array (a Python scalar becomes a 0-d numpy
array, as ``np.asarray`` makes it).  The file is a msgpack document as
``msgpack.packb(..., use_bin_type=True)`` writes it; the port carries
its own encoder and decoder of the subset the format uses (map, str,
bin, array, int, float, bool, nil, each in msgpack's shortest form), so
it needs no ``msgpack`` package.  A file the port saves is identical to
the reference's for the same tree, and each package restores the
other's.

Leaves may be torch tensors (any device; bfloat16 is written under the
dtype name ``"bfloat16"``, as ml_dtypes names it) or numpy arrays.
``restore`` gives CPU torch tensors (numpy arrays for a dtype torch does
not have, such as a string's).  A language model's checkpoint holds the
reference's stacked layout (``convert.lm_params_to_jax``);
``restore_like`` unstacks it into a template's per-layer lists.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

# dtype names the format writes, and the torch dtype each restores to
TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


# ---------------------------------------------------------------------------
# msgpack, the subset the format uses
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xff)
    elif 0 <= n <= 0xff:
        out += b"\xcc" + struct.pack(">B", n)
    elif 0 <= n <= 0xffff:
        out += b"\xcd" + struct.pack(">H", n)
    elif 0 <= n <= 0xffffffff:
        out += b"\xce" + struct.pack(">I", n)
    elif 0 <= n <= 0xffffffffffffffff:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif -0x8000 <= n < 0:
        out += b"\xd1" + struct.pack(">h", n)
    elif -0x80000000 <= n < 0:
        out += b"\xd2" + struct.pack(">i", n)
    elif -0x8000000000000000 <= n < 0:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray):
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form of ``codes`` (None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf: bytes, pos: int):
    """One object from ``buf`` at ``pos`` -> (object, next position)."""
    b = buf[pos]
    pos += 1

    def take(fmt):
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + n])[0], pos + n

    def seq(n, p):
        vals = []
        for _ in range(n):
            v, p = _unpack(buf, p)
            vals.append(v)
        return vals, p

    def mapping(n, p):
        out = {}
        for _ in range(n):
            k, p = _unpack(buf, p)
            v, p = _unpack(buf, p)
            out[k] = v
        return out, p

    if b < 0x80:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return mapping(b & 0x0f, pos)
    if 0x90 <= b <= 0x9f:
        return seq(b & 0x0f, pos)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
            0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    if b in ints:
        return take(ints[b])
    lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
            0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
    if b in lens:
        n, pos = take(lens[b])
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(buf[pos:pos + n]), pos + n
        if b in (0xd9, 0xda, 0xdb):
            return buf[pos:pos + n].decode("utf-8"), pos + n
        if b in (0xdc, 0xdd):
            return seq(n, pos)
        return mapping(n, pos)
    raise ValueError(f"msgpack type byte 0x{b:02x} at {pos - 1} is not "
                     f"one the checkpoint format writes")


def unpackb(data: bytes):
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the msgpack "
                         f"document")
    return obj


# ---------------------------------------------------------------------------
# the tree format
# ---------------------------------------------------------------------------

def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _array(obj):
    """(dtype name, shape, bytes) of a leaf, as ``np.asarray`` sees it."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            data = t.view(torch.int16).numpy().tobytes()
        else:
            data = t.numpy().tobytes()
        return _DTYPE_NAMES[t.dtype], list(t.shape), data
    arr = np.asarray(obj)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _encode(obj):
    if obj is None:
        return {"__lit__": None}
    if isinstance(obj, dict):
        return {"__map__": {k: _encode(obj[k]) for k in sorted(obj)}}
    if _is_namedtuple(obj):
        return {"__nt__": type(obj).__name__,
                "fields": {f: _encode(getattr(obj, f))
                           for f in obj._fields}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_encode(v) for v in obj],
                "tuple": isinstance(obj, tuple)}
    dtype, shape, data = _array(obj)
    return {"__arr__": True, "dtype": dtype, "shape": shape, "data": data}


def _leaf(obj):
    dtype, shape = obj["dtype"], obj["shape"]
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(obj["data"]),
                                dtype=torch.int16).view(
            torch.bfloat16).reshape(shape).clone()
    arr = np.frombuffer(obj["data"], dtype=dtype).reshape(shape).copy()
    if dtype in TORCH_DTYPES:
        return torch.from_numpy(arr)
    return arr


def _decode(obj):
    if "__arr__" in obj:
        return _leaf(obj)
    if "__map__" in obj:
        return {k: _decode(v) for k, v in obj["__map__"].items()}
    if "__nt__" in obj:
        # restored as plain dict of fields: callers re-wrap if needed
        return {f: _decode(v) for f, v in obj["fields"].items()}
    if "__seq__" in obj:
        vals = [_decode(v) for v in obj["__seq__"]]
        return tuple(vals) if obj.get("tuple") else vals
    return obj["__lit__"]


def save(path: str, tree: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(_encode(tree)))
    os.replace(tmp, path)


def restore(path: str) -> Any:
    with open(path, "rb") as f:
        return _decode(unpackb(f.read()))


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _align(raw, like, where: str):
    if isinstance(like, dict):
        if not isinstance(raw, dict) or set(raw) != set(like):
            raise ValueError(f"checkpoint/template mismatch at {where}: "
                             f"keys {sorted(like)} wanted")
        return {k: _align(raw[k], like[k], f"{where}/{k}")
                for k in sorted(like)}
    if _is_namedtuple(like):            # restored as a dict of fields
        return type(like)(*(_align(raw[f], t, f"{where}/{f}")
                            for f, t in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        if isinstance(raw, dict):       # a stacked tree: one per layer
            raw = [_layer(raw, i) for i in range(len(like))]
        if len(raw) != len(like):
            raise ValueError(f"checkpoint/template mismatch at {where}: "
                             f"{len(raw)} entries, {len(like)} wanted")
        return type(like)(_align(r, t, f"{where}[{i}]")
                          for i, (r, t) in enumerate(zip(raw, like)))
    if like is None or raw is None:
        if like is not raw:
            raise ValueError(f"checkpoint/template mismatch at {where}")
        return None
    if isinstance(like, torch.Tensor):
        t = torch.as_tensor(raw)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint/template mismatch at {where}: "
                             f"shape {tuple(t.shape)}, "
                             f"{tuple(like.shape)} wanted")
        return t.to(device=like.device, dtype=like.dtype)
    return raw


def restore_like(path: str, template: Any) -> Any:
    """Restore into the template's structure, each leaf cast to the
    template leaf's dtype and placed on its device (namedtuples
    re-wrapped).  Where the template holds a per-layer list and the file
    a stacked tree (the reference's layout of a language model's
    ``blocks``), the stacked leaves are cut along their leading axis."""
    return _align(restore(path), template, "")
