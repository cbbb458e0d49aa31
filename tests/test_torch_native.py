"""The port's C WFDB decoder (``scgrhc_torch.native``) on its record read.

``scgrhc_torch.io.wfdb.rdrecord`` takes the C path for single-frame groups
in formats 16/24/32/61/80/160/212; each read is held bit for bit (NaNs in
the same places) to the port's NumPy decode and to
``scgrhc.io.wfdb.rdrecord``, with ``scgrhc``'s own C decoder built and
with it set aside.  Records come from the port's ``wrrecord`` and a numpy
seed; sentinel samples are written into the ``.dat`` afterwards."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import scgrhc.native
import scgrhc_torch.native as native
from scgrhc.io import wfdb as jw
from scgrhc_torch.io import wfdb as w

ROOT = Path(__file__).resolve().parents[1]
C_FMTS = ["16", "24", "32", "61", "80", "160", "212"]
BASELINE, GAIN = 7, 200.0
SENTINEL_AT = (0, 5, -1)  # flat positions of the interleaved stream


@pytest.fixture(scope="module", autouse=True)
def scgrhc_native_built():
    """Build ``scgrhc``'s extension as tests/test_native.py does."""
    if scgrhc.native.decode_calibrate is None and not scgrhc.native.build_inplace():
        pytest.skip("no C toolchain for scgrhc's extension")


@pytest.fixture
def c_calls(monkeypatch):
    """Spy on the C entry point: the number of groups it decoded."""
    calls = []
    real = native.decode_calibrate_into

    def spy(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "decode_calibrate_into", spy)
    return calls


def _record(tmp_path, fmt, n_sig, sig_len=1001, seed=0, sentinels=True):
    """A record of random ADC values over the format's whole writable range,
    with the format's sentinel at SENTINEL_AT."""
    rng = np.random.default_rng(seed)
    lo, hi = w._WRITE_RANGE[fmt]
    adc = rng.integers(lo, hi, size=(sig_len, n_sig), endpoint=True).astype(np.int32)
    path = str(tmp_path / f"rec{fmt}_{n_sig}_{sig_len}")
    w.wrrecord(path, 500, [f"s{i}" for i in range(n_sig)], (adc - BASELINE) / GAIN,
               gain=GAIN, baseline=BASELINE, fmt=fmt)
    if sentinels:
        flat = adc.reshape(-1)
        flat[list(SENTINEL_AT)] = w.SENTINELS[fmt]
        w._encode_stream(flat, fmt, path + ".dat")
    return path


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint64)


def _jax_reads(path, monkeypatch) -> dict:
    """``scgrhc``'s read with its C decoder, then without it."""
    reads = {"scgrhc C": jw.rdrecord(path).p_signal}
    with monkeypatch.context() as m:
        m.setattr(scgrhc.native, "decode_calibrate", None)
        reads["scgrhc NumPy"] = jw.rdrecord(path).p_signal
    return reads


def _hold(got: np.ndarray, refs: dict) -> None:
    for what, ref in refs.items():
        np.testing.assert_array_equal(got, ref, err_msg=what)  # NaNs in the same places
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=what)


@pytest.mark.parametrize("n_sig", [1, 3])
@pytest.mark.parametrize("fmt", C_FMTS)
def test_c_read_equals_numpy_and_scgrhc(tmp_path, fmt, n_sig, c_calls, monkeypatch):
    path = _record(tmp_path, fmt, n_sig)
    got = w.rdrecord(path).p_signal
    assert c_calls == [int(fmt)]
    assert np.isnan(got).sum() == len(SENTINEL_AT)
    assert np.isnan(got.reshape(-1)[list(SENTINEL_AT)]).all()
    _hold(got, {"port NumPy": w.rdrecord_numpy(path).p_signal, **_jax_reads(path, monkeypatch)})


@pytest.mark.parametrize("sig_len", [1, 7, 1001])
def test_fmt212_odd_sample_count(tmp_path, sig_len, c_calls, monkeypatch):
    """n_sig x sig_len odd: the last 3-byte pair holds one sample."""
    path = _record(tmp_path, "212", 3, sig_len=sig_len, sentinels=sig_len > 5)
    assert (3 * sig_len) % 2 == 1
    got = w.rdrecord(path).p_signal
    assert c_calls == [212] and got.shape == (sig_len, 3)
    _hold(got, {"port NumPy": w.rdrecord_numpy(path).p_signal, **_jax_reads(path, monkeypatch)})


@pytest.mark.parametrize("fmt", ["16", "212"])
def test_header_gain_zero_reads_as_200(tmp_path, fmt, c_calls, monkeypatch):
    path = _record(tmp_path, fmt, 3)
    hea = Path(path + ".hea")
    hea.write_text(hea.read_text().replace(f"{GAIN:.12g}({BASELINE})", f"0({BASELINE})"))
    got = w.rdrecord(path).p_signal
    assert c_calls == [int(fmt)]
    _hold(got, {"port NumPy": w.rdrecord_numpy(path).p_signal, **_jax_reads(path, monkeypatch)})
    # the C decoder's own rule, reached only by a direct call
    raw = Path(path + ".dat").read_bytes()
    zero = native.decode_calibrate(raw, int(fmt), 3, 1001, [BASELINE] * 3, [0.0] * 3)
    _hold(zero, {"gain 200": native.decode_calibrate(raw, int(fmt), 3, 1001, [BASELINE] * 3,
                                                     [200.0] * 3),
                 "scgrhc": scgrhc.native.decode_calibrate(raw, int(fmt), 3, 1001,
                                                          [BASELINE] * 3, [0.0] * 3)})


def _write_multiframe(tmp_path) -> str:
    """fmt 16x2 + 16 interleaved: per frame s0a s0b s1, one frame with a
    sentinel in signal 0."""
    rng = np.random.default_rng(3)
    frames = rng.integers(-30000, 30000, size=(50, 3)).astype("<i2")
    frames[4, 1] = -32768
    (tmp_path / "mf.dat").write_bytes(frames.tobytes())
    (tmp_path / "mf.hea").write_text(
        "mf 2 500 50\n"
        f"mf.dat 16x2 {GAIN:g}({BASELINE})/mV 16 {BASELINE} 0 0 0 a\n"
        f"mf.dat 16 {GAIN:g}({BASELINE})/mV 16 {BASELINE} 0 0 0 b\n")
    return str(tmp_path / "mf")


@pytest.mark.parametrize("case", ["8", "310", "311", "16x2"])
def test_other_groups_never_reach_c(tmp_path, case, c_calls, monkeypatch):
    if case == "16x2":
        path = _write_multiframe(tmp_path)
    elif case == "8":  # int8 first differences: a slow walk
        rng = np.random.default_rng(1)
        walk = np.cumsum(rng.integers(-60, 61, size=(1001, 3)), axis=0)
        path = str(tmp_path / "rec8")
        w.wrrecord(path, 500, ["a", "b", "c"], walk / GAIN, gain=GAIN, fmt="8")
    else:
        path = _record(tmp_path, case, 3)
    got = w.rdrecord(path).p_signal
    assert c_calls == []
    _hold(got, {"port NumPy": w.rdrecord_numpy(path).p_signal, **_jax_reads(path, monkeypatch)})


@pytest.mark.parametrize("fmt", C_FMTS)
def test_short_dat_raises(tmp_path, fmt, c_calls):
    path = _record(tmp_path, fmt, 3, sentinels=False)
    dat = Path(path + ".dat")
    dat.write_bytes(dat.read_bytes()[: dat.stat().st_size // 2])
    with pytest.raises(ValueError, match="header promises 3003"):
        w.rdrecord(path)
    assert c_calls == [int(fmt)]
    with pytest.raises(ValueError):
        jw.rdrecord(path)


@pytest.mark.parametrize("fmt", C_FMTS)
def test_decode_calibrate_equals_scgrhc(fmt):
    """The module's own entry point, against ``scgrhc.native``'s."""
    rng = np.random.default_rng(int(fmt))
    raw = rng.integers(0, 256, size=4 * 2 * 301, dtype=np.uint8).tobytes()
    args = (int(fmt), 2, 301, [3.0, -11.0], [200.0, 0.5])
    got = native.decode_calibrate(raw, *args)
    assert got.shape == (301, 2) and got.dtype == np.float64
    _hold(got, {"scgrhc": scgrhc.native.decode_calibrate(raw, *args)})


@pytest.mark.parametrize("args", [(8, 1, 2, [0.0], [1.0]), (16, 0, 2, [], []),
                                  (16, 1, -1, [0.0], [1.0]), (16, 1, 2, [0.0, 1.0], [1.0])])
def test_decode_calibrate_rejects_bad_arguments(args):
    with pytest.raises(ValueError):
        native.decode_calibrate(b"\x00" * 8, *args)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """A process with no build loaded yet, building into an empty directory."""
    monkeypatch.setattr(native, "_build", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_missing_compiler_raises(fresh_build, monkeypatch):
    path = _record(fresh_build, "16", 3)
    monkeypatch.setattr(native, "COMPILERS", (str(fresh_build / "no-such-cc"),))
    with pytest.raises(RuntimeError, match="no C compiler found"):
        w.rdrecord(path)  # no NumPy read instead


def test_failed_compile_raises_with_its_stderr(fresh_build, monkeypatch):
    path = _record(fresh_build, "212", 3)
    cc = fresh_build / "bad-cc"
    cc.write_text("#!/bin/sh\necho 'bad-cc: refused' >&2\nexit 1\n")
    cc.chmod(0o755)
    monkeypatch.setattr(native, "COMPILERS", (str(cc),))
    with pytest.raises(RuntimeError, match="bad-cc: refused"):
        w.rdrecord(path)
    assert list((fresh_build / "build").iterdir()) == []  # no half-written library


def test_second_call_reuses_the_build(fresh_build, monkeypatch):
    first = native.build()
    assert first.seconds > 0 and first.path.parent == fresh_build / "build"
    assert native.build() is first  # in this process
    # a new process finds the finished file and runs no compiler
    monkeypatch.setattr(native, "_build", None)
    monkeypatch.setattr(native, "COMPILERS", (str(fresh_build / "no-such-cc"),))
    again = native.build()
    assert again.path == first.path and again.seconds == 0.0
    assert sorted(p.name for p in (fresh_build / "build").iterdir()) == [first.path.name]


_BUILD_PROC = """
import sys
from pathlib import Path
import scgrhc_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
native.decode_calibrate(b"\\x01\\x00", 16, 1, 1, [0.0], [1.0])
print(native.build().path)
"""


def test_concurrent_first_builds(tmp_path):
    """Processes that build at once each load a whole library."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROC, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(outs[0][0].strip()).name]
