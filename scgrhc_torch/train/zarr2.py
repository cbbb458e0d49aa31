"""zarr v2 arrays, as Orbax keeps a checkpoint's leaves.

Each array is keys of the checkpoint's OCDBT store
(:mod:`scgrhc_torch.train.ocdbt`): ``<name>/.zarray``, the JSON metadata
tensorstore writes, and one zstd frame per chunk of a regular grid,
``<name>/i.j.k`` in row-major order (``<name>/0`` for a scalar), each the
C-order chunk at its full ``chunks`` shape; chunks at the array's far edge
are cut to it.  The dtypes are the ones the training state holds: float32
(``<f4``) and int32 (``<i4``).

The port's writer puts each array in one chunk (``chunks == shape``).
Orbax's replica-parallel save of a state replicated over ``n`` devices
writes a grid instead: the first axis that ``n`` divides is cut in ``n``
(:func:`replica_chunks`), each replica writing its slice.  The reader
takes any regular grid; a chunk that is missing or of another size raises,
naming the array: no writer of these checkpoints leaves a chunk out.
"""

from __future__ import annotations

import json
import math

import numpy as np

from scgrhc_torch.native import zstd

DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4")}
ZSTD_LEVEL = 1  # tensorstore's zarr zstd compressor in Orbax's checkpoints


def chunk_key(name: str, index: tuple[int, ...]) -> str:
    return f"{name}/{'.'.join(map(str, index)) or '0'}"


def replica_chunks(shape, replicas: int) -> list[int]:
    """The chunk shape of an array of ``shape`` that Orbax's save of a state
    replicated over ``replicas`` devices writes: the first axis that
    ``replicas`` divides, cut in ``replicas``; one chunk if none does."""
    chunks = list(shape)
    for d, s in enumerate(chunks):
        if s % replicas == 0:
            chunks[d] = s // replicas
            break
    return chunks


def encode(name: str, array: np.ndarray, chunks=None) -> dict[bytes, bytes]:
    """The store entries of ``array`` under ``name``: one chunk, or the grid
    of ``chunks`` with full-size edge chunks (zero past the edge), as
    tensorstore writes it."""
    a = np.asarray(array)
    code = a.dtype.newbyteorder("<").str
    if code not in DTYPES:
        raise ValueError(f"{name}: dtype {a.dtype} has no zarr encoding here")
    shape = list(a.shape)
    chunks = shape if chunks is None else [int(c) for c in chunks]
    grid = _grid(name, shape, chunks)
    meta = {"chunks": chunks, "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": code, "fill_value": None, "filters": None,
            "order": "C", "shape": shape, "zarr_format": 2}
    a = np.asarray(a, dtype=DTYPES[code], order="C")
    out = {f"{name}/.zarray".encode(): json.dumps(meta, separators=(",", ":")).encode()}
    for index in np.ndindex(*grid):
        part = a[_slices(index, chunks, shape)]
        if list(part.shape) != chunks:
            part = np.pad(part, [(0, c - s) for c, s in zip(chunks, part.shape)])
        out[chunk_key(name, index).encode()] = zstd.compress(part.tobytes(), ZSTD_LEVEL)
    return out


def _grid(name: str, shape: list, chunks: list) -> tuple[int, ...]:
    if len(chunks) != len(shape) or any(not isinstance(c, int) or c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} do not fit shape {shape}")
    return tuple(math.ceil(s / c) for s, c in zip(shape, chunks))


def _slices(index, chunks, shape) -> tuple[slice, ...]:
    return tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))


def decode(name: str, store: dict[bytes, bytes]) -> np.ndarray:
    """The array ``name`` of a store read by :func:`ocdbt.read`."""
    try:
        meta = json.loads(store[f"{name}/.zarray".encode()])
    except KeyError:
        raise KeyError(f"{name}: no .zarray in the checkpoint") from None
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: unsupported zarr array {meta}")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{name}: dimension_separator {meta['dimension_separator']!r}, "
                         f"not '.'")
    shape, chunks, dtype = list(meta["shape"]), list(meta["chunks"]), DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ValueError(f"{name}: unsupported dtype {meta['dtype']}")
    grid = _grid(name, shape, chunks)
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: unsupported compressor {compressor}")
    nbytes = dtype.itemsize * math.prod(chunks)
    out = np.empty(shape, dtype)
    for index in np.ndindex(*grid):
        key = chunk_key(name, index)
        chunk = store.get(key.encode())
        if chunk is None:
            if meta.get("fill_value") is not None:  # no writer of these checkpoints omits one
                raise ValueError(f"{name}: chunk {key} is missing; filling it with "
                                 f"{meta['fill_value']!r} is not supported")
            raise KeyError(f"{name}: chunk {key} is missing")
        raw = chunk if compressor is None else zstd.decompress(chunk, size_hint=nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{name}: chunk {key} holds {len(raw)} bytes, {chunks} of "
                             f"{meta['dtype']} need {nbytes}")
        at = _slices(index, chunks, shape)
        out[at] = np.frombuffer(raw, dtype).reshape(chunks)[tuple(slice(0, s.stop - s.start)
                                                                  for s in at)]
    return out
