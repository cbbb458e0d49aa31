"""The port's stream_infer against scgrhc.parallel.stream.stream_infer with
the same weights, in float32.

A short window (T=96) keeps the full-width U-Net cheap on the CPU; the
framing, calibration, chunking and blending arithmetic do not depend on
it.  Tolerance: the two packages' f32 CPU convolutions sum in different
orders (see tests/test_torch_generator.py), so 1e-4 on outputs of O(1).
"""

import jax
import numpy as np
import pytest
import torch

from scgrhc.models import generator as jgen
from scgrhc.parallel import stream as jstream
from scgrhc_torch.models.convert import generator_from_jax_params
from scgrhc_torch.parallel import stream as tstream

T = 96
C = 2
ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, jgen.init(jax.random.key(0), C))
    return params, generator_from_jax_params(params)


def _adc_record(rng, length):
    gain = np.asarray([1000.0, 500.0], np.float32)
    base = np.asarray([10.0, -5.0], np.float32)
    sentinel = np.asarray([-32768.0, -32768.0], np.float32)
    rec = rng.random((C, length)).astype(np.float32) * 2 - 1
    adc = np.clip(rec * gain[:, None] + base[:, None], -32767, 32767).astype(np.int16)
    return adc, (gain, base, sentinel)


# (name, length, batch, overlap, rhc_minmax, adc, sentinel_at)
CASES = [
    ("float-tail", T * 5 + 37, 512, 0, None, False, None),
    ("float-chunked-denorm", T * 7, 3, 0, (-3.0, 5.0), False, None),
    ("int16-sentinel", T * 6 + 11, 512, 0, None, True, T * 2 + 5),
    ("int16-overlap-chunked", T * 6, 4, T // 4, (2.0, 40.0), True, None),
]


@pytest.mark.parametrize("name,length,batch,overlap,minmax,adc,sentinel_at", CASES,
                         ids=[c[0] for c in CASES])
def test_stream_infer_matches_jax(weights, name, length, batch, overlap, minmax,
                                  adc, sentinel_at):
    params, gen = weights
    rng = np.random.default_rng(len(name))
    kw = dict(segment_samples=T, batch=batch, overlap=overlap, rhc_minmax=minmax)
    if adc:
        rec, cal = _adc_record(rng, length)
        if sentinel_at is not None:
            rec[1, sentinel_at] = -32768
        kw["calibration"] = cal
    else:
        rec = (rng.random((C, length)) * 4 - 2).astype(np.float32)
    want = jstream.stream_infer(params, rec, **kw)
    got = tstream.stream_infer(gen, rec, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    hop = T - overlap
    assert got.shape == (hop * ((length - T) // hop) + T,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if sentinel_at is not None:  # the sentinel's window, and only it, is NaN
        w = sentinel_at // T
        assert np.isnan(got[w * T:(w + 1) * T]).all()
        assert np.isfinite(np.delete(got, np.s_[w * T:(w + 1) * T])).all()
    scale = 1.0 if minmax is None else minmax[1] - minmax[0]  # denorm range
    np.testing.assert_allclose(got, want, atol=ATOL * scale, equal_nan=True)


def test_chunked_matches_single_chunk(weights):
    """Windows are independent, so chunking changes no value beyond the
    f32 jitter of batch-size-dependent conv algorithms (the JAX package's
    own fused-vs-chunked tolerance, tests/test_parallel.py)."""
    _, gen = weights
    rec = np.random.default_rng(5).random((C, T * 9)).astype(np.float32)
    one = tstream.stream_infer(gen, rec, segment_samples=T)
    many = tstream.stream_infer(gen, rec, segment_samples=T, batch=2)
    np.testing.assert_allclose(one, many, atol=2e-5)


def test_frame_record_matches_jax():
    x = np.arange(2 * 10, dtype=np.float32).reshape(2, 10)
    for hop in (None, 3):
        want = np.asarray(jstream.frame_record(x, 4, hop))
        got = tstream.frame_record(torch.from_numpy(x), 4, hop).numpy()
        np.testing.assert_array_equal(got, want)
    assert tstream.frame_record(torch.zeros(2, 3), 4).shape == (0, 2, 4)


def test_blend_matches_jax():
    pred = np.random.default_rng(6).random((5, 40)).astype(np.float32)
    for hop in (40, 30, 25):
        np.testing.assert_array_equal(tstream._blend(pred, hop, 40),
                                      jstream._blend(pred, hop, 40))


@pytest.mark.parametrize("bad", [T, T + 5, -1])
def test_rejects_bad_overlap(weights, bad):
    _, gen = weights
    with pytest.raises(ValueError, match="overlap"):
        tstream.stream_infer(gen, np.zeros((C, T * 3), np.float32),
                             segment_samples=T, overlap=bad)


def test_short_record_gives_empty_waveform(weights):
    _, gen = weights
    out = tstream.stream_infer(gen, np.zeros((C, T - 1), np.float32), segment_samples=T)
    assert out.shape == (0,) and out.dtype == np.float32
