"""Minimal, self-contained WFDB record reader/writer (the port's copy of
``scgrhc.io.wfdb``).

The reference relies on the ``wfdb`` PyPI package only for
``wfdb.rdrecord(...).p_signal`` / ``.sig_name`` (reference:
recordutil.py:113-119,137).  This module provides that surface from scratch:
a pure-NumPy parser for WFDB ``.hea`` headers and ``.dat`` signal files, plus
a writer used by the synthetic-record fixtures.  :func:`rdrecord` decodes
and calibrates single-frame groups in formats 16/24/32/61/80/160/212 in one
C pass (:mod:`scgrhc_torch.native`, built at first use; no fallback), where
``scgrhc`` takes its C decoder; :func:`decode_group_numpy` is the NumPy
decode it is held to bit for bit, and reads the other formats.

Supported signal storage formats: 16 (little-endian int16 — the common case
for this dataset), 61 (big-endian int16), 32 (little-endian int32), 24
(little-endian 3-byte), 80 (8-bit offset binary), 160 (16-bit offset
binary), 212 (packed 12-bit pairs, the classic PhysioNet format), 310/311
(packed 10-bit triplets, word-split and LSB-first layouts), and 8
(8-bit first differences).  Each
signal group may live in its own ``.dat`` file or share one interleaved
file; ``fmtxN`` multi-frame signals (``samps_per_frame`` > 1) are smoothed
by frame averaging, matching ``wfdb.rdrecord``'s default
``smooth_frames=True``.

Invalid-sample sentinels map to NaN in ``p_signal`` exactly like the wfdb
package: −32768 (fmt 16/61), −2048 (fmt 212), −2147483648 (fmt 32),
−8388608 (fmt 24), −128 (fmt 80), −32768 (fmt 160), −512 (fmt 310/311).
Format 8 stores differences and has no representable sentinel.

Physical conversion follows the WFDB spec: ``p = (adc - baseline) / gain``
with gain defaulting to 200 when the header gives 0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from scgrhc_torch import native

DEFAULT_GAIN = 200.0


@dataclass
class SignalSpec:
    """One signal line of a ``.hea`` header."""

    file_name: str
    fmt: str
    gain: float
    baseline: int
    units: str
    adc_res: int
    adc_zero: int
    init_value: int
    checksum: int
    block_size: int
    sig_name: str
    samps_per_frame: int = 1


# Invalid-sample sentinel ADC values per format (WFDB spec; the wfdb
# package maps these to NaN in p_signal — recordutil.py:137 consumes
# p_signal, so parity requires the same mapping).
SENTINELS = {
    "16": -32768,
    "61": -32768,
    "160": -32768,
    "212": -2048,
    "32": -2147483648,
    "24": -8388608,
    "80": -128,
    "310": -512,
    "311": -512,
}


@dataclass
class Record:
    """Parsed WFDB record; mirrors the ``wfdb.Record`` attributes the
    reference consumes (``sig_name``, ``p_signal``, ``fs``, ``sig_len``)."""

    record_name: str
    fs: float
    sig_len: int
    sig_name: list[str]
    p_signal: np.ndarray  # (sig_len, n_sig) float64
    specs: list[SignalSpec] = field(default_factory=list)

    @property
    def n_sig(self) -> int:
        return len(self.sig_name)


def _parse_gain_baseline_units(tok: str) -> tuple[float, int | None, str]:
    """Parse the WFDB ``gain(baseline)/units`` token."""
    units = ""
    if "/" in tok:
        tok, units = tok.split("/", 1)
    baseline = None
    if "(" in tok:
        tok, rest = tok.split("(", 1)
        baseline = int(rest.rstrip(")"))
    gain = float(tok) if tok else 0.0
    return gain, baseline, units


def read_header(hea_path: str) -> tuple[str, float, int, list[SignalSpec]]:
    """Parse a ``.hea`` file → (record_name, fs, sig_len, signal specs)."""
    lines: list[str] = []
    with open(hea_path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            lines.append(line)
    head = lines[0].split()
    record_name = head[0].split("/")[0]
    n_sig = int(head[1])
    fs = float(head[2].split("/")[0]) if len(head) > 2 else 250.0
    sig_len = int(head[3]) if len(head) > 3 else 0

    specs: list[SignalSpec] = []
    for line in lines[1 : 1 + n_sig]:
        toks = line.split()
        file_name = toks[0]
        # format token: fmt[xSPF][:skew][+byte_offset]
        fmt_tok = toks[1].split(":")[0].split("+")[0]
        if "x" in fmt_tok:
            fmt, spf_s = fmt_tok.split("x", 1)
            samps_per_frame = int(spf_s)
        else:
            fmt, samps_per_frame = fmt_tok, 1
        gain, baseline, units = (
            _parse_gain_baseline_units(toks[2]) if len(toks) > 2 else (0.0, None, "")
        )
        adc_res = int(toks[3]) if len(toks) > 3 else 12
        adc_zero = int(toks[4]) if len(toks) > 4 else 0
        init_value = int(toks[5]) if len(toks) > 5 else 0
        checksum = int(toks[6]) if len(toks) > 6 else 0
        block_size = int(toks[7]) if len(toks) > 7 else 0
        sig_name = toks[8] if len(toks) > 8 else f"sig_{len(specs)}"
        if baseline is None:
            baseline = adc_zero
        if gain == 0.0:
            gain = DEFAULT_GAIN
        specs.append(
            SignalSpec(
                file_name=file_name,
                fmt=fmt,
                gain=gain,
                baseline=baseline,
                units=units,
                adc_res=adc_res,
                adc_zero=adc_zero,
                init_value=init_value,
                checksum=checksum,
                block_size=block_size,
                sig_name=sig_name,
                samps_per_frame=samps_per_frame,
            )
        )
    return record_name, fs, sig_len, specs


def _decode_stream(raw: np.ndarray, fmt: str, path: str) -> np.ndarray:
    """uint8 buffer → flat int32 sample (or, for fmt 8, difference) stream."""
    if fmt == "16":
        return raw[: raw.size // 2 * 2].view("<i2").astype(np.int32)
    if fmt == "61":
        return raw[: raw.size // 2 * 2].view(">i2").astype(np.int32)
    if fmt == "32":
        return raw[: raw.size // 4 * 4].view("<i4").astype(np.int32)
    if fmt == "24":
        n = raw.size // 3
        b = raw[: n * 3].reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v[v > 0x7FFFFF] -= 0x1000000  # sign-extend 24-bit
        return v
    if fmt == "80":
        return raw.astype(np.int32) - 128
    if fmt == "160":
        return raw[: raw.size // 2 * 2].view("<u2").astype(np.int32) - 32768
    if fmt == "8":
        return raw.view(np.int8).astype(np.int32)  # first differences
    if fmt == "212":
        # Packed 12-bit pairs: 3 bytes → 2 samples.
        n_pairs = raw.size // 3
        b = raw[: n_pairs * 3].reshape(-1, 3).astype(np.int32)
        first = ((b[:, 1] & 0x0F) << 8) | b[:, 0]
        second = ((b[:, 1] & 0xF0) << 4) | b[:, 2]
        adc = np.empty(n_pairs * 2, dtype=np.int32)
        adc[0::2] = first
        adc[1::2] = second
        adc[adc > 2047] -= 4096  # sign-extend 12-bit
        return adc
    if fmt == "310":
        # Packed 10-bit triplets, 4 bytes → 3 samples (WFDB signal(5)):
        # two LE 16-bit words per group; samples 0/1 are bits 1-10 of each
        # word (bit 0 unused), sample 2 splices the two words' top-5 bits
        # (word 2's five MSBs are its high half, word 1's its low half).
        n_grp = raw.size // 4
        w = raw[: n_grp * 4].view("<u2").astype(np.int32).reshape(-1, 2)
        adc = np.empty(n_grp * 3, dtype=np.int32)
        adc[0::3] = (w[:, 0] >> 1) & 0x3FF
        adc[1::3] = (w[:, 1] >> 1) & 0x3FF
        adc[2::3] = ((w[:, 1] >> 11) << 5) | (w[:, 0] >> 11)
        adc[adc > 511] -= 1024  # sign-extend 10-bit
        return adc
    if fmt == "311":
        # Packed 10-bit triplets, 4 bytes → 3 samples: one LE 32-bit word
        # holds samples in its low 30 bits, LSB-first (top 2 bits unused).
        n_grp = raw.size // 4
        w = raw[: n_grp * 4].view("<u4").astype(np.int64)
        adc = np.empty(n_grp * 3, dtype=np.int32)
        adc[0::3] = w & 0x3FF
        adc[1::3] = (w >> 10) & 0x3FF
        adc[2::3] = (w >> 20) & 0x3FF
        adc[adc > 511] -= 1024  # sign-extend 10-bit
        return adc
    raise ValueError(
        f"Unsupported WFDB format {fmt!r} in {path} "
        "(supported: 8/16/24/32/61/80/160/212/310/311)"
    )


def decode_group_numpy(path: str, fmt: str, specs: list[SignalSpec], idxs: list[int],
                       sig_len: int, p_signal: np.ndarray) -> None:
    """The NumPy decode and calibration of one signal group (the signals
    ``idxs`` of ``specs``, interleaved in the ``.dat`` at ``path``) into
    those columns of ``p_signal``: formats 8, 310, 311 and multi-frame
    groups in :func:`rdrecord`, and the reference that the C decoder
    (:mod:`scgrhc_torch.native`) is held to bit for bit."""
    frame_samps = [specs[i].samps_per_frame for i in idxs]
    frame_size = sum(frame_samps)
    raw = np.fromfile(path, dtype=np.uint8)
    adc = _decode_stream(raw, fmt, path)
    total = frame_size * sig_len
    if adc.size < total:
        raise ValueError(
            f"{path}: .dat holds {adc.size} samples but header promises "
            f"{total} ({frame_size} samples/frame x {sig_len} frames)"
        )
    frames = adc[:total].reshape(sig_len, frame_size)
    sentinel = SENTINELS.get(fmt)
    col = 0
    for sig_idx, spf in zip(idxs, frame_samps):
        spec = specs[sig_idx]
        block = frames[:, col : col + spf]
        col += spf
        if fmt == "8":
            # first differences: samples = init_value + cumsum(diffs)
            block = spec.init_value + np.cumsum(block[:, 0])[:, None]
            invalid = None
        else:
            invalid = block == sentinel
        phys = (block.astype(np.float64) - spec.baseline) / spec.gain
        if invalid is not None and invalid.any():
            phys[invalid] = np.nan
        # multi-frame smoothing = frame mean (wfdb smooth_frames=True);
        # a frame with any invalid sample smooths to NaN
        p_signal[:, sig_idx] = phys[:, 0] if spf == 1 else phys.mean(axis=1)


NATIVE_FMTS = ("16", "24", "32", "61", "80", "160", "212")


def _decode_group(path: str, fmt: str, specs: list[SignalSpec], idxs: list[int],
                  sig_len: int, p_signal: np.ndarray) -> None:
    """A single-frame group in a format of ``NATIVE_FMTS`` through the C
    decoder, straight into its ``p_signal`` columns; any other through
    :func:`decode_group_numpy` (``scgrhc.io.wfdb.rdrecord``'s routing)."""
    if fmt not in NATIVE_FMTS or any(specs[i].samps_per_frame != 1 for i in idxs):
        decode_group_numpy(path, fmt, specs, idxs, sig_len, p_signal)
        return
    try:
        native.decode_calibrate_into(
            np.fromfile(path, dtype=np.uint8), int(fmt), sig_len,
            [float(specs[i].baseline) for i in idxs], [specs[i].gain for i in idxs],
            p_signal, idxs)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _read(record_path: str, decode_group) -> Record:
    """The header, then each ``.dat`` file's signal group through
    ``decode_group`` into one ``p_signal``."""
    hea_path = record_path + ".hea"
    record_name, fs, sig_len, specs = read_header(hea_path)
    dirname = os.path.dirname(record_path)

    # Group signals by their .dat file (WFDB interleaves within a file).
    groups: dict[str, list[int]] = {}
    for idx, spec in enumerate(specs):
        groups.setdefault(spec.file_name, []).append(idx)

    p_signal = np.empty((sig_len, len(specs)), dtype=np.float64)
    for file_name, idxs in groups.items():
        fmts = {specs[i].fmt for i in idxs}
        if len(fmts) != 1:
            raise ValueError(f"Mixed formats in {file_name}: {fmts}")
        fmt = fmts.pop()
        path = os.path.join(dirname, file_name)
        if fmt == "8" and any(specs[i].samps_per_frame != 1 for i in idxs):
            raise ValueError(
                f"{path}: format 8 with samps_per_frame > 1 is not supported"
            )
        decode_group(path, fmt, specs, idxs, sig_len, p_signal)
    return Record(
        record_name=record_name,
        fs=fs,
        sig_len=sig_len,
        sig_name=[s.sig_name for s in specs],
        p_signal=p_signal,
        specs=specs,
    )


def rdrecord(record_path: str) -> Record:
    """Read a WFDB record (path without extension) → :class:`Record`.

    Drop-in for the subset of ``wfdb.rdrecord`` the pipeline needs
    (reference: recordutil.py:137).  Single-frame groups in formats
    16/24/32/61/80/160/212 go through the C decoder, which is built at
    first use (:mod:`scgrhc_torch.native`).
    """
    return _read(record_path, _decode_group)


def rdrecord_numpy(record_path: str) -> Record:
    """:func:`rdrecord` with every group through :func:`decode_group_numpy`:
    the reference for the C decoder, which no path of the port calls."""
    return _read(record_path, decode_group_numpy)


DIGITAL_FMTS = ("16", "61", "80", "160", "212", "310", "311")


def rdrecord_digital(record_path: str):
    """Read a record's DIGITAL (ADC) samples without host-side calibration.

    Returns ``(d_signal (sig_len, n_sig) int16, gains, baselines,
    sentinels)`` — the float64 per-signal calibration vectors and the
    int sentinel ADC value per signal — or ``None`` when the record
    cannot be represented this way (multi-frame signals, or formats
    whose samples exceed int16: 8/24/32).

    Purpose: host→device transfer of a whole record at 2 bytes/sample
    (every supported format's samples fit int16), with the
    ``(adc − baseline)/gain`` physical conversion and sentinel→NaN
    mapping running on the device as part of streaming inference
    (:func:`scgrhc_torch.parallel.stream.stream_infer` ``calibration=``).
    """
    hea_path = record_path + ".hea"
    _, _, sig_len, specs = read_header(hea_path)
    dirname = os.path.dirname(record_path)
    if any(s.samps_per_frame != 1 for s in specs):
        return None
    if any(s.fmt not in DIGITAL_FMTS for s in specs):
        return None

    d_signal = np.empty((sig_len, len(specs)), dtype=np.int16)
    groups: dict[str, list[int]] = {}
    for idx, spec in enumerate(specs):
        groups.setdefault(spec.file_name, []).append(idx)
    for file_name, idxs in groups.items():
        if len({specs[i].fmt for i in idxs}) != 1:
            # mixed formats in one interleaved .dat: not representable as a
            # single decode pass — fall back to the float path, which raises
            # the explicit "Mixed formats" error (rdrecord above) instead of
            # silently decoding the whole stream as the first signal's format
            return None
        fmt = specs[idxs[0]].fmt
        path = os.path.join(dirname, file_name)
        raw = np.fromfile(path, dtype=np.uint8)
        adc = _decode_stream(raw, fmt, path)
        total = len(idxs) * sig_len
        if adc.size < total:
            raise ValueError(
                f"{path}: .dat holds {adc.size} samples but header promises "
                f"{total}"
            )
        frames = adc[:total].reshape(sig_len, len(idxs))
        for col, sig_idx in enumerate(idxs):
            d_signal[:, sig_idx] = frames[:, col].astype(np.int16)

    gains = np.array([s.gain for s in specs], dtype=np.float64)
    baselines = np.array([s.baseline for s in specs], dtype=np.float64)
    sentinels = np.array(
        [SENTINELS[s.fmt] for s in specs], dtype=np.float64
    )
    return d_signal, gains, baselines, sentinels


# Writable ADC range per format.  The lower bound excludes the sentinel
# value (SENTINELS) so a legitimately clipped sample can never round-trip
# to NaN; fmt 8 is bounded by its int8 difference stream instead (checked
# in _encode_stream).
_WRITE_RANGE = {
    "16": (-32767, 32767),
    "61": (-32767, 32767),
    "32": (-(2**31) + 1, 2**31 - 1),
    "24": (-8388607, 8388607),
    "80": (-127, 127),
    "160": (-32767, 32767),
    "212": (-2047, 2047),
    "310": (-511, 511),
    "311": (-511, 511),
    "8": (-(2**31) + 1, 2**31 - 1),
}

_ADC_RES = {
    "16": 16, "61": 16, "32": 32, "24": 24, "80": 8, "160": 16,
    "212": 12, "310": 10, "311": 10, "8": 8,
}


def _encode_stream(flat: np.ndarray, fmt: str, dat_path: str) -> None:
    """Inverse of :func:`_decode_stream`: flat int32 sample (or, for fmt 8,
    difference) stream → ``.dat`` bytes."""
    if fmt == "16":
        flat.astype("<i2").tofile(dat_path)
    elif fmt == "61":
        flat.astype(">i2").tofile(dat_path)
    elif fmt == "32":
        flat.astype("<i4").tofile(dat_path)
    elif fmt == "24":
        u = (flat & 0xFFFFFF).astype(np.uint32)  # two's complement, low 3 B
        b = np.empty((flat.size, 3), dtype=np.uint8)
        b[:, 0] = u & 0xFF
        b[:, 1] = (u >> 8) & 0xFF
        b[:, 2] = (u >> 16) & 0xFF
        b.tofile(dat_path)
    elif fmt == "80":
        (flat + 128).astype(np.uint8).tofile(dat_path)
    elif fmt == "160":
        (flat + 32768).astype("<u2").tofile(dat_path)
    elif fmt == "8":
        info = np.iinfo(np.int8)
        if flat.min() < info.min or flat.max() > info.max:
            raise ValueError(
                "format 8 stores int8 first differences; the signal's "
                f"sample-to-sample slew ({flat.min()}..{flat.max()}) "
                "does not fit — use a wider format or rescale"
            )
        flat.astype(np.int8).tofile(dat_path)
    elif fmt == "212":
        # pack 12-bit pairs: sample0 low byte | [hi4(s1)<<4 | hi4(s0)] | s1 low
        if flat.size % 2:
            flat = np.concatenate([flat, np.zeros(1, dtype=np.int32)])
        u = np.where(flat < 0, flat + 4096, flat).astype(np.uint16)
        first, second = u[0::2], u[1::2]
        packed = np.empty((first.size, 3), dtype=np.uint8)
        packed[:, 0] = first & 0xFF
        packed[:, 1] = ((first >> 8) & 0x0F) | (((second >> 8) & 0x0F) << 4)
        packed[:, 2] = second & 0xFF
        packed.tofile(dat_path)
    else:  # 310/311: pack 10-bit triplets into 4 bytes
        if flat.size % 3:
            flat = np.concatenate(
                [flat, np.zeros(3 - flat.size % 3, dtype=np.int32)]
            )
        u = np.where(flat < 0, flat + 1024, flat).astype(np.uint32)
        s0, s1, s2 = u[0::3], u[1::3], u[2::3]
        if fmt == "310":
            w = np.empty((s0.size, 2), dtype=np.uint16)
            w[:, 0] = ((s0 << 1) | ((s2 & 0x1F) << 11)).astype(np.uint16)
            w[:, 1] = ((s1 << 1) | ((s2 >> 5) << 11)).astype(np.uint16)
            w.astype("<u2").tofile(dat_path)
        else:
            (s0 | (s1 << 10) | (s2 << 20)).astype("<u4").tofile(dat_path)


def wrrecord(
    record_path: str,
    fs: float,
    sig_names: list[str],
    p_signal: np.ndarray,
    gain: float = 1000.0,
    baseline: int = 0,
    fmt: str = "16",
    units: str = "mV",
) -> None:
    """Write a WFDB record (any supported read format; single interleaved
    ``.dat``).

    Used by synthetic-dataset fixtures and the all-format round-trip fuzz
    tests; physical values are quantized through the ADC model, so
    ``rdrecord(wrrecord(x))`` matches ``x`` to 1/(2·gain) when the signal
    fits the format's ADC range (out-of-range samples clip, never landing
    on the NaN sentinel).  Format 8 stores int8 first differences and
    raises if the quantized slew exceeds that range.
    """
    if fmt not in _WRITE_RANGE:
        raise ValueError(
            f"writer supports formats {'/'.join(sorted(_WRITE_RANGE))} only"
        )
    p_signal = np.asarray(p_signal, dtype=np.float64)
    sig_len, n_sig = p_signal.shape
    if n_sig != len(sig_names):
        raise ValueError("p_signal column count != len(sig_names)")
    record_name = os.path.basename(record_path)
    dat_name = record_name + ".dat"

    lo, hi = _WRITE_RANGE[fmt]
    adc = np.clip(np.round(p_signal * gain + baseline), lo, hi).astype(
        np.int32
    )

    with open(record_path + ".hea", "w") as f:
        f.write(f"{record_name} {n_sig} {fs:g} {sig_len}\n")
        for j, name in enumerate(sig_names):
            init_value = int(adc[0, j]) if sig_len else 0
            checksum = int(np.sum(adc[:, j], dtype=np.int64) & 0xFFFF)
            f.write(
                # .12g: %g's default 6 significant digits would round the
                # calibration gain enough to exceed quantization error
                f"{dat_name} {fmt} {gain:.12g}({baseline})/{units} "
                f"{_ADC_RES[fmt]} "
                f"{baseline} {init_value} {checksum} 0 {name}\n"
            )

    if fmt == "8" and sig_len:
        # decode is samples[k] = init_value + cumsum(diffs)[k] per signal
        # (init_value above is adc[0], so the first stored diff is 0)
        flat = np.diff(adc, axis=0, prepend=adc[:1]).reshape(-1)
    else:
        flat = adc.reshape(-1)
    _encode_stream(
        flat, fmt, os.path.join(os.path.dirname(record_path), dat_name)
    )
