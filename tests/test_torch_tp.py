"""The port's model axis (``scgrhc_torch.parallel.tp``) against
``scgrhc.parallel.tp``.

  * ``param_pspecs``: equal to ``scgrhc``'s leaf by leaf, through the key
    map of ``models/convert.py``, at tp = 1, 2, 3, 4 and 8.
  * The tensor-parallel forward (``shard_params``) at 1×2 (a 2-rank gloo
    world on the CPU) and 2×2 (4 ranks: the batch split over the data axis
    as well), float64, B = 5 windows (a block padded on the data axis):
    every rank's output against the port's replicated forward and against
    ``scgrhc``'s forward with ``shard_params`` on ``make_dp_tp_mesh(2,
    2)`` (and 1×2) at the f64 oracle tier's rtol 1e-9; each rank holds its
    shards; the mesh is laid out row-major; the forward makes 20
    collectives on the model axis (14 channel all-gathers, 6 partial-sum
    all-reduces) and one on the data axis at dp = 2.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scgrhc.models import generator as jgen
from scgrhc.parallel import tp as jtp
from scgrhc_torch.models.convert import generator_from_jax_params, state_dict_from_jax_params
from scgrhc_torch.parallel import tp
from test_torch_parallel import enable_x64, run_world

RTOL = 1e-9
C, T, B = 2, 24, 5
MESHES = ((1, 2), (2, 2))

WORKER = r"""
import os, pickle, sys
rank, io_dir, dp, tpn = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm
comm.init_distributed("file://" + os.path.join(io_dir, "store"), dp * tpn, rank, device="cpu",
                      timeout_s=60)
from scgrhc_torch.models.convert import generator_from_state_dict
from scgrhc_torch.parallel import tp
with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
gen = generator_from_state_dict(inp["g_sd"]).eval()
mesh = tp.make_dp_tp_mesh(dp, tpn)
model = tp.shard_params(gen, mesh)
counts = {"all_gather": 0, "all_reduce": 0}
def counted(key, fn):
    def wrapped(*a, **k):
        counts[key] += 1
        return fn(*a, **k)
    return wrapped
comm.all_gather = counted("all_gather", comm.all_gather)
comm.all_reduce_sum = counted("all_reduce", comm.all_reduce_sum)
with torch.inference_mode():
    y = model(torch.from_numpy(inp["x"]))
out = {"y": y.numpy(), "counts": counts,
       "mesh": {k: (m.size, m.rank) for k, m in mesh.items()},
       "shapes": {k: tuple(v.shape) for k, v in model.gen.state_dict().items()}}
with open(os.path.join(io_dir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
comm.destroy()
"""


def _jax_params():
    return jax.tree.map(lambda a: np.asarray(a, np.float64), jgen.init(jax.random.key(0), C))


@pytest.mark.parametrize("tp_size", [1, 2, 3, 4, 8])
def test_param_pspecs_match_jax_leaf_by_leaf(tp_size):
    params = _jax_params()
    specs = jax.tree.map(lambda s: np.asarray(tuple(s), dtype=object),
                         jtp.param_pspecs(params, tp_size), is_leaf=lambda s: isinstance(s, P))
    want = {k: tuple(v) for k, v in state_dict_from_jax_params(specs).items()}
    got = tp.param_pspecs(generator_from_jax_params(params), tp_size)
    assert got == want
    assert tp.MODEL_AXIS == jtp.MODEL_AXIS
    if tp_size in (2, 4, 8):
        assert got["enc1.0.weight"] == ("model", None, None)
        assert got["final.weight"] == got["att3.psi.0.weight"] == (None, None, None)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params = _jax_params()
    x = np.random.default_rng(5).random((B, C, T))
    out = {}
    for dp, tpn in MESHES:
        tmp = tmp_path_factory.mktemp(f"tp{dp}x{tpn}")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump({"g_sd": state_dict_from_jax_params(params), "x": x}, f)
        procs = run_world(tmp, WORKER, n=dp * tpn, args=(str(dp), str(tpn)))
        for p in procs:
            assert p.returncode == 0, p.stdout[-4000:]
        ranks = []
        for r in range(dp * tpn):
            with open(tmp / f"out{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[dp, tpn] = ranks
    return params, x, out


@pytest.mark.parametrize("dp,tpn", MESHES)
def test_tensor_parallel_forward_matches_replicated_and_jax(worlds, dp, tpn):
    params, x, out = worlds
    gen = generator_from_jax_params(params).eval()
    with torch.inference_mode():
        want = gen(torch.from_numpy(x)).numpy()
    with enable_x64():
        jp = jax.tree.map(jnp.asarray, params)
        fwd = jax.jit(lambda p, a: jgen.apply(p, a, train=False))
        ref = np.asarray(fwd(jtp.shard_params(jp, jtp.make_dp_tp_mesh(dp, tpn)),
                             jnp.asarray(x)))
    for r, rec in enumerate(out[dp, tpn]):
        assert rec["mesh"] == {"data": (dp, r // tpn), "model": (tpn, r % tpn)}
        assert rec["shapes"]["enc1.0.weight"] == (64 // tpn, C, 3)
        assert rec["shapes"]["up3.weight"] == (512 // tpn, 256, 3)
        assert rec["shapes"]["final.weight"] == (1, 64, 1)
        assert rec["counts"] == {"all_gather": 14 + (dp > 1), "all_reduce": 6}
        np.testing.assert_allclose(rec["y"], want, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(rec["y"], ref, rtol=RTOL, atol=1e-12)
