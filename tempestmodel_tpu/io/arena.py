"""ctypes bindings for the native arena serialization library.

JAX analog of the reference ``DataContainer`` arena
(``src/base/DataContainer.{h,cpp}``) used by the composite checkpoint: a
C++ library (``native/arena.cpp``) packs named arrays into one contiguous
64-byte-aligned buffer with per-array checksums and multithreaded memcpy.
Compiled on first use with g++ (cached next to the source); a pure-numpy
fallback keeps everything working without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libtempest_arena.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "arena.cpp")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) or (
            os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_SO_PATH)):
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC_PATH, "-o", _SO_PATH],
            check=True, capture_output=True)
    lib = ctypes.CDLL(_SO_PATH)
    lib.ta_required_bytes.restype = ctypes.c_int64
    lib.ta_required_bytes.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ta_pack.restype = ctypes.c_int64
    lib.ta_pack.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_int64]
    lib.ta_count.restype = ctypes.c_int64
    lib.ta_count.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ta_entry.restype = ctypes.c_int64
    lib.ta_entry.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.ta_unpack.restype = ctypes.c_int64
    lib.ta_unpack.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _meta_encode(name: str, arr: np.ndarray) -> str:
    shape = ",".join(str(s) for s in arr.shape)
    return f"{name}|{arr.dtype.str}|{shape}"


def _meta_decode(tag: str):
    name, dtype, shape = tag.split("|")
    shp = tuple(int(s) for s in shape.split(",")) if shape else ()
    return name, np.dtype(dtype), shp


def pack(arrays: dict) -> bytes:
    """Pack {name: ndarray} into one arena buffer."""
    lib = _load()
    items = [(k, np.ascontiguousarray(v)) for k, v in arrays.items()]
    n = len(items)
    names = (ctypes.c_char_p * n)(
        *[_meta_encode(k, v).encode() for k, v in items])
    ptrs = (ctypes.c_void_p * n)(
        *[v.ctypes.data_as(ctypes.c_void_p).value for _, v in items])
    sizes = (ctypes.c_int64 * n)(*[v.nbytes for _, v in items])
    need = lib.ta_required_bytes(n, names, sizes)
    buf = np.empty(need, dtype=np.uint8)
    written = lib.ta_pack(n, names, ptrs, sizes,
                          buf.ctypes.data_as(ctypes.c_void_p), need)
    if written < 0:
        raise RuntimeError("arena pack overflow")
    return buf[:written].tobytes()


def unpack(data: bytes) -> dict:
    """Restore {name: ndarray} from an arena buffer (checksum-verified)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    ptr = buf.ctypes.data_as(ctypes.c_void_p)
    n = lib.ta_count(ptr, len(buf))
    if n < 0:
        raise ValueError("not an arena buffer")
    out = {}
    for i in range(n):
        name_buf = ctypes.create_string_buffer(4096)
        nbytes = ctypes.c_int64()
        if lib.ta_entry(ptr, i, name_buf, 4096, ctypes.byref(nbytes)) != 0:
            raise ValueError(f"bad arena entry {i}")
        name, dtype, shape = _meta_decode(name_buf.value.decode())
        arr = np.empty(shape, dtype=dtype)
        rc = lib.ta_unpack(ptr, i, arr.ctypes.data_as(ctypes.c_void_p),
                           arr.nbytes)
        if rc == -2:
            raise ValueError(f"checksum mismatch for {name!r}")
        if rc != 0:
            raise ValueError(f"unpack failure for {name!r}")
        out[name] = arr
    return out


def save(path: str, arrays: dict):
    with open(path, "wb") as f:
        f.write(pack(arrays))


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return unpack(f.read())
