"""zstd through the host's ``libzstd.so.1``, bound with ctypes.

Orbax checkpoints (:mod:`scgrhc_torch.train.orbax_io`) keep their B+tree
nodes, manifests and array chunks as zstd frames.  The library is a system
C library (Debian's and Ubuntu's ``dpkg`` depend on it); it is loaded at the
first call, never at import, and a host without it raises ``RuntimeError``
naming it.  There is no fallback.

Frames written by tensorstore carry no content size, so :func:`decompress`
asks ``ZSTD_findDecompressedSize`` first and streams through
``ZSTD_decompressStream`` when the size is unknown.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_STREAM_CHUNK = 1 << 20  # output bytes per streaming step when no size is known

_P, _SIZE = ctypes.c_void_p, ctypes.c_size_t


class _InBuffer(ctypes.Structure):  # ZSTD_inBuffer
    _fields_ = [("src", _P), ("size", _SIZE), ("pos", _SIZE)]


class _OutBuffer(ctypes.Structure):  # ZSTD_outBuffer
    _fields_ = [("dst", _P), ("size", _SIZE), ("pos", _SIZE)]


_SIGNATURES = {
    "ZSTD_versionString": ((), ctypes.c_char_p),
    "ZSTD_isError": ((_SIZE,), ctypes.c_uint),
    "ZSTD_getErrorName": ((_SIZE,), ctypes.c_char_p),
    "ZSTD_compressBound": ((_SIZE,), _SIZE),
    "ZSTD_compress": ((_P, _SIZE, _P, _SIZE, ctypes.c_int), _SIZE),
    "ZSTD_findDecompressedSize": ((_P, _SIZE), ctypes.c_ulonglong),
    "ZSTD_decompress": ((_P, _SIZE, _P, _SIZE), _SIZE),
    "ZSTD_createDCtx": ((), _P),
    "ZSTD_freeDCtx": ((_P,), _SIZE),
    "ZSTD_decompressStream": ((_P, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)),
                              _SIZE),
}

_lock = threading.Lock()
_lib = None


def library():
    """The bound ``libzstd`` (loaded once per process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        names = [LIBRARY] + [n for n in (ctypes.util.find_library("zstd"),) if n and n != LIBRARY]
        errors = []
        for name in names:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(f"{name}: {e}")
        else:
            raise RuntimeError(f"{LIBRARY} not found (tried {'; '.join(errors)}): Orbax "
                               "checkpoints are zstd-compressed and need the host's libzstd")
        for fn, (args, res) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(args), res
        _lib = lib
        return lib


def version() -> str:
    """The loaded library's version, e.g. ``"1.5.5"``."""
    return library().ZSTD_versionString().decode()


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what} failed: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data, level: int = 1) -> bytes:
    """One zstd frame of ``data`` at ``level``, with its content size."""
    lib = library()
    src = bytes(data)
    cap = lib.ZSTD_compressBound(len(src))
    dst = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(dst, cap, src, len(src), level), "compression")
    return dst.raw[:n]


def decompress(frame, size_hint: int | None = None) -> bytes:
    """The content of one or more concatenated zstd frames.  Frames that
    all state their content size are decoded in one call; otherwise the
    input is streamed, starting from an output buffer of ``size_hint``
    bytes.  Corrupt or truncated input raises ``ValueError``."""
    lib = library()
    src = bytes(frame)
    size = lib.ZSTD_findDecompressedSize(src, len(src))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd decompression failed: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN:
        dst = ctypes.create_string_buffer(max(int(size), 1))
        n = _check(lib, lib.ZSTD_decompress(dst, len(dst), src, len(src)), "decompression")
        if n != size:
            raise ValueError(f"zstd decompression failed: {n} bytes, the frames say {size}")
        return dst.raw[:n]
    return _stream(lib, src, size_hint or _STREAM_CHUNK)


def _stream(lib, src: bytes, cap: int) -> bytes:
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        inp = _InBuffer(ctypes.cast(ctypes.c_char_p(src), _P), len(src), 0)
        parts = []
        ret = 1
        while inp.pos < inp.size or ret != 0:
            dst = ctypes.create_string_buffer(max(cap, 1))
            out = _OutBuffer(ctypes.cast(dst, _P), len(dst), 0)
            ret = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(out),
                                                         ctypes.byref(inp)), "decompression")
            parts.append(dst.raw[:out.pos])
            if ret != 0 and inp.pos == inp.size and out.pos < out.size:
                raise ValueError("zstd decompression failed: truncated frame")
            cap = _STREAM_CHUNK
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDCtx(dctx)
