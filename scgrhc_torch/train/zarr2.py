"""zarr v2 arrays of one chunk, as Orbax keeps a checkpoint's leaves.

Each array is two keys of the checkpoint's OCDBT store
(:mod:`scgrhc_torch.train.ocdbt`): ``<name>/.zarray``, the JSON metadata
tensorstore writes, and ``<name>/0.0...0`` (``<name>/0`` for a scalar),
the whole C-order array as one zstd frame.  The dtypes are the ones the
training state holds: float32 (``<f4``) and int32 (``<i4``).
"""

from __future__ import annotations

import json

import numpy as np

from scgrhc_torch.native import zstd

DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4")}
ZSTD_LEVEL = 1  # tensorstore's zarr zstd compressor in Orbax's checkpoints


def chunk_key(name: str, ndim: int) -> str:
    return f"{name}/{'.'.join('0' * ndim) or '0'}"


def encode(name: str, array: np.ndarray) -> dict[bytes, bytes]:
    """The two store entries of ``array`` under ``name``."""
    a = np.asarray(array)
    code = a.dtype.newbyteorder("<").str
    if code not in DTYPES:
        raise ValueError(f"{name}: dtype {a.dtype} has no zarr encoding here")
    shape = list(a.shape)
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": code, "fill_value": None, "filters": None,
            "order": "C", "shape": shape, "zarr_format": 2}
    raw = np.ascontiguousarray(a, dtype=DTYPES[code]).tobytes()
    return {f"{name}/.zarray".encode(): json.dumps(meta, separators=(",", ":")).encode(),
            chunk_key(name, a.ndim).encode(): zstd.compress(raw, ZSTD_LEVEL)}


def decode(name: str, store: dict[bytes, bytes]) -> np.ndarray:
    """The array ``name`` of a store read by :func:`ocdbt.read`."""
    try:
        meta = json.loads(store[f"{name}/.zarray".encode()])
    except KeyError:
        raise KeyError(f"{name}: no .zarray in the checkpoint") from None
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: unsupported zarr array {meta}")
    shape, dtype = tuple(meta["shape"]), DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ValueError(f"{name}: unsupported dtype {meta['dtype']}")
    if tuple(meta["chunks"]) != shape:
        raise ValueError(f"{name}: {meta['chunks']} chunks of {list(shape)}: one chunk only")
    compressor = meta.get("compressor")
    chunk = store.get(chunk_key(name, len(shape)).encode())
    if chunk is None:
        raise KeyError(f"{name}: its chunk is missing")
    nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
    if compressor is None:
        raw = chunk
    elif compressor.get("id") == "zstd":
        raw = zstd.decompress(chunk, size_hint=nbytes)
    else:
        raise ValueError(f"{name}: unsupported compressor {compressor}")
    if len(raw) != nbytes:
        raise ValueError(f"{name}: chunk holds {len(raw)} bytes, {list(shape)} needs {nbytes}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
