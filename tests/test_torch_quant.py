"""The port's int8 inference (scgrhc_torch.models.quant) against
scgrhc.models.quant, with the same weights carried across by
``generator_from_jax_params``.

  * The quantized weights (``wq``, ``ws``, ``b``) of all 17 convs equal
    ``quantize_generator``'s bit for bit, the 3 upsampling convs in their
    pre-lowered layout; an activation's int8 values and scale equal
    ``_quantize_act``'s.
  * One ``_conv_q``'s int8 × int8 product equals JAX's int32 exactly, at
    channel counts that are no multiple of 8, at 16 rows or fewer, and at
    the upsampling's padding of 2.
  * The whole int8 forward at T = 750, B = 4 against JAX's int8 forward:
    the two dequantize and normalize in float32 in other orders, so an
    activation next to a rounding boundary can round to the other int8
    value, and 17 quantized convs carry such flips on (5e-6 of the first
    layer's values flip).  Measured: max abs difference 0.246, least
    per-window PCC 0.986 (outputs within about ±3); held to 0.5 and 0.95.
  * Each window's int8 output against the f32 forward: PCC above 0.9 (as
    tests/test_quant.py asks of the JAX package).
  * ``Generator.cast(torch.int8)`` returns the quantized module and leaves
    the generator as it was; its forward in train mode raises.
  * ``eval.infer.predict_split`` and ``eval.run`` with ``dtype: "int8"``,
    as tests/test_quant.py:117-142 holds the JAX package's.
  * On SCG windows the int8 forward's PCC against f32 is the JAX
    package's, window by window, well below its 0.9 on uniform noise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from scgrhc.core.params import Params as JParams
from scgrhc.data.store import SegmentStore as JSegmentStore
from scgrhc.eval import infer as jinfer
from scgrhc.eval import run as jeval
from scgrhc.models import generator as jgen
from scgrhc.models import quant as jquant
from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc_torch.core.params import Params
from scgrhc_torch.data.loaders import SegmentLoader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.eval import infer
from scgrhc_torch.eval import run as eval_run
from scgrhc_torch.models import quant
from scgrhc_torch.models.convert import generator_from_jax_params
from scgrhc_torch.models.generator import BLOCKS
from scgrhc_torch.select.run import get_float_array

T = 750
FWD_MAX_ABS, FWD_MIN_PCC = 0.5, 0.95
MIN_PCC_VS_F32 = 0.9


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, jgen.init(jax.random.key(0), 4))
    gen = generator_from_jax_params(params).eval()
    return params, gen, jgen.cast_params(jax.tree.map(jnp.asarray, params), jnp.int8)


@pytest.fixture(scope="module")
def forwards(setup):
    """The int8 forwards of both packages and the port's f32 forward on the
    same uniform windows (4, 4, 750)."""
    params, gen, jq = setup
    x = np.random.default_rng(1).random((4, 4, T)).astype(np.float32)
    want = np.asarray(jgen.apply(jq, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = gen.cast(torch.int8)(torch.from_numpy(x)).numpy()
        f32 = gen(torch.from_numpy(x)).numpy()
    return got, want, f32


def _pcc(a, b):
    return [float(np.corrcoef(u, v)[0, 1]) for u, v in zip(a[:, 0], b[:, 0])]


def test_quantized_weights_equal_jax(setup):
    _, gen, jq = setup
    q = gen.cast(torch.int8)
    assert isinstance(q, quant.QuantGenerator)
    convs = [(getattr(q, name)[i], jq[name][key]) for name, _, _ in BLOCKS
             for i, key in enumerate(("conv1", "conv2"))]
    convs += [(getattr(q, name), jq[name]) for name in ("up3", "up2", "up1")]
    assert len(convs) == 17
    for mine, theirs in convs:
        assert mine.wq.dtype == torch.int8 and mine.ws.dtype == mine.b.dtype == torch.float32
        for k in ("wq", "ws", "b"):
            np.testing.assert_array_equal(getattr(mine, k).numpy(), np.asarray(theirs[k]))
    assert [getattr(q, n).padding for n in ("up3", "up2", "up1")] == [2, 2, 2]
    assert q.final.weight.dtype == torch.float32 and q.att1.psi[0].weight.dtype == torch.float32


def test_quantize_act_equals_jax():
    x = np.random.default_rng(3).standard_normal((3, 5, 40)).astype(np.float32) * 7
    xq, s = quant.quantize_act(torch.from_numpy(x))
    jxq, js = jquant._quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert xq.dtype == torch.int8 and float(s) == float(js)


@pytest.mark.parametrize("n,ci,t,o,pad", [(3, 4, 50, 64, 1), (2, 3, 750, 64, 1),
                                          (1, 512, 9, 256, 2), (1, 5, 3, 7, 1)])
def test_conv_q_equals_jax_int32(n, ci, t, o, pad):
    rng = np.random.default_rng(n * ci + t)
    xq = rng.integers(-127, 128, (n, ci, t), dtype=np.int8)
    wq = rng.integers(-127, 128, (o, ci, 3), dtype=np.int8)
    want = lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq), (1,), [(pad, pad)],
                                    dimension_numbers=("NCH", "OIH", "NCH"),
                                    preferred_element_type=jnp.int32)
    got = quant.int8_conv(torch.from_numpy(xq), torch.from_numpy(wq), pad)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # dequantized with sx · ws, plus the bias, in float32
    ws = rng.uniform(1e-3, 1e-2, o).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, o).astype(np.float32)
    sx = np.float32(0.02)
    layer = {"wq": jnp.asarray(wq), "ws": jnp.asarray(ws), "b": jnp.asarray(b)}
    conv = quant.QConv(torch.zeros(o, ci, 3), torch.from_numpy(b), pad)
    conv.wq, conv.ws = torch.from_numpy(wq), torch.from_numpy(ws)
    np.testing.assert_allclose(conv(torch.from_numpy(xq), torch.tensor(sx)).numpy(),
                               np.asarray(jquant._conv_q(jnp.asarray(xq), sx, layer, pad)),
                               rtol=1e-6, atol=1e-6)


def test_int8_forward_matches_jax(forwards):
    got, want, _ = forwards
    assert got.shape == want.shape == (4, 1, T) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) < FWD_MAX_ABS
    assert min(_pcc(got, want)) > FWD_MIN_PCC


def test_int8_forward_tracks_f32(forwards):
    got, _, f32 = forwards
    assert min(_pcc(got, f32)) > MIN_PCC_VS_F32


def test_cast_int8_leaves_the_generator_and_refuses_training(setup):
    _, gen, _ = setup
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    q = gen.cast(torch.int8)
    assert gen.dtype == torch.float32
    assert all(torch.equal(before[k], v) for k, v in gen.state_dict().items())
    x = torch.rand(1, 4, 32)
    with pytest.raises(ValueError, match="inference-only"):
        q(x, train=True)
    g = generator_from_jax_params(jax.tree.map(np.asarray, jgen.init(jax.random.key(1), 4)))
    assert g.cast(torch.bfloat16) is g


def _store(n, c, seed, cls=SegmentStore):
    rng = np.random.default_rng(seed)
    mm = np.stack([np.full(n, -10.0), np.full(n, 40.0)], axis=1)
    return cls(rng.random((n, c, T)).astype(np.float32),
                        rng.random((n, 1, T)).astype(np.float32),
                        [f"rec{i}" for i in range(n)], np.arange(n, dtype=np.int64),
                        np.arange(n, dtype=np.int64) + T, mm.copy(), mm.copy(),
                        segment_samples=T)


@pytest.mark.parametrize("batch", [6, 4])
def test_predict_split_int8(setup, batch):
    """The split scored in int8 in one chunk, and in chunks of 4 and 2 (an
    activation scale spans a chunk, so both packages chunk alike; JAX pads
    the last chunk with zero windows, which leave the scales as they are):
    finite, each window's denormalized prediction correlated with the f32
    path's above 0.9 and with the JAX package's int8 prediction above
    FWD_MIN_PCC."""
    params, gen, _ = setup
    store = _store(6, 4, 0)
    _, p32, _ = infer.predict_split(gen, store, batch=batch)
    _, pq, sq = infer.predict_split(gen.cast(torch.int8), store, batch=batch)
    _, jq, _ = jinfer.predict_split(jax.tree.map(jnp.asarray, params),
                                    _store(6, 4, 0, JSegmentStore), batch=batch, dtype="int8")
    assert np.isfinite(pq).all() and np.isfinite(sq["pcc_r"]).all()
    for i in range(len(store)):
        assert np.corrcoef(p32[i], pq[i])[0, 1] > MIN_PCC_VS_F32
        assert np.corrcoef(jq[i], pq[i])[0, 1] > FWD_MIN_PCC


def _write_params(d, **extra):
    import json

    cfg = {"dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"],
           "chamber": "PA", "segment_size": 1.5, "batch_size": 4,
           "train_path": "loader_train.pickle", "valid_path": "loader_valid.pickle",
           "test_path": "loader_test.pickle", "checkpoint_dir_path": "checkpoints",
           "comparison_dir_path": "comparisons", "pred_top_dir_path": "pred_top",
           "pred_rand_dir_path": "pred_rand", "alpha": 1e-4, "beta1": 0.5, "beta2": 0.999,
           "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100, "total_epochs": 1,
           "min_RHC": -50, "use_global_min_max": False, "eval_batch": 8, **extra}
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "params.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_eval_run_int8_matches_jax(tmp_path):
    """``test <dir> valid <ckpt>`` with ``dtype: "int8"`` on a checkpoint
    written by scgrhc: the same rows as scgrhc's int8 stage, finite scores,
    each window's prediction correlated with scgrhc's above FWD_MIN_PCC.
    ``eval_batch`` 8 puts the 3 windows in one chunk in both packages:
    scgrhc's stage shards its chunks over the tests' 8 virtual devices and
    rounds the chunk up to 8 (the chunking itself is held by
    test_predict_split_int8)."""
    d = tmp_path / "exp"
    p = Params(_write_params(d, dtype="int8"))
    SegmentLoader(_store(3, 2, 1), 1, seed=1).save(p.valid_path)
    os.makedirs(p.checkpoint_dir_path)
    jckpt.save(os.path.join(p.checkpoint_dir_path, "000.checkpoint"), start_time=0.0, epoch=0,
               g_losses=[], d_losses=[], state=init_state(jax.random.key(2), 2, TrainConfig()))
    eval_run.run(p, "valid", "000.checkpoint", device="cpu")
    ours = (d / "comparisons" / "valid" / "000.csv").read_text().splitlines()
    os.rename(d / "comparisons", d / "ours")
    jeval.run(JParams(_write_params(d, dtype="int8")), "valid", "000.checkpoint")
    theirs = (d / "comparisons" / "valid" / "000.csv").read_text().splitlines()
    assert len(ours) == len(theirs) == 4 and ours[0] == theirs[0]

    def rows(lines):
        import csv

        return {(r["filename"], r["start_idx"]): r for r in csv.DictReader(lines)}

    got, want = rows(ours), rows(theirs)
    assert got.keys() == want.keys()
    for k, w in want.items():
        a, b = get_float_array(got[k]["pred_rhc"]), get_float_array(w["pred_rhc"])
        assert np.isfinite(a).all() and np.isfinite(float(got[k]["pcc_r"]))
        assert got[k]["real_rhc"] == w["real_rhc"]
        assert np.corrcoef(a, b)[0, 1] > FWD_MIN_PCC


def test_int8_on_scg_windows_loses_what_jax_loses(setup, synth_db, monkeypatch):
    """On SCG windows (the synthetic records' first 4 PA windows, each
    min-max normalized as the data stage does) the int8 forward follows
    the f32 one less closely than on uniform noise, in the JAX package as
    in the port: the per-window PCC of int8 against f32 of the two
    packages agree within 0.05 (measured 0.58-0.72 in the port, 0.59-0.70
    in scgrhc).  A low PCC there is the int8 method's, not the port's."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.dsp.segment import get_segments

    monkeypatch.setattr(paths, "DATA_PATH", os.path.dirname(synth_db))
    monkeypatch.setattr(paths, "PROCESSED_DATA_PATH", synth_db)

    class P:
        in_channels = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]
        chamber, segment_size, min_RHC, data_backend = "PA", 1.5, -50, "host"

    scg = np.stack([s.scg.T for s in get_segments(P())[:4]]).astype(np.float32)
    lo, hi = scg.min(axis=(1, 2), keepdims=True), scg.max(axis=(1, 2), keepdims=True)
    x = ((scg - lo) / (hi - lo + 1e-4)).astype(np.float32)
    params, gen, jq = setup
    with torch.inference_mode():
        mine = _pcc(gen.cast(torch.int8)(torch.from_numpy(x)).numpy(),
                    gen(torch.from_numpy(x)).numpy())
    theirs = _pcc(np.asarray(jgen.apply(jq, jnp.asarray(x), train=False)),
                  np.asarray(jgen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                        train=False)))
    print(f"\nint8 vs f32 per-window PCC on SCG windows: port {mine}, scgrhc {theirs}")
    np.testing.assert_allclose(mine, theirs, atol=0.05)
