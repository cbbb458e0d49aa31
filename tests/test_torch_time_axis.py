"""The port's time axis (``scgrhc_torch.models.cp.apply_cp``, K1f's two
time-sharded phases, ``ops.nn.instance_norm_global``, the halo exchange of
``parallel.comm``) against ``scgrhc.models.cp``.

  * K1f's plain phases over a record cut in two blocks, each with its
    neighbour's edge column (non-zero halos), their row sums added as the
    all-reduce adds them: against ``scgrhc``'s ``_conv3`` and
    ``_instance_norm_global`` under ``shard_map`` on a 2-device time mesh,
    and the attention gates' global norm likewise, in float64 at the f64
    oracle tier's rtol 1e-9 (PARITY.md "Float64 oracle tier").
  * ``apply_cp`` at world size 2 and 4 (gloo worlds on the CPU through a
    ``file://`` store), L = 1024, float64: every rank's output against
    ``scgrhc``'s ``apply_cp`` on ``make_mesh(n, axis=TIME_AXIS)`` and
    against ``apply_continuous`` of both packages at rtol 1e-9, every rank
    equal to rank 0, and the collectives a forward makes, counted: 20 halo
    exchanges, 23 norm all-reduces, 1 output gather.
  * A record whose length does not divide the ranks is refused, and one
    rank's ``apply_cp`` (a mesh of one) is ``apply_continuous``.
"""

import os
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from scgrhc.models import cp as jcp
from scgrhc.models import generator as jgen
from scgrhc.parallel import mesh as jmesh
from scgrhc_torch.models import cp
from scgrhc_torch.models.convert import generator_from_jax_params, state_dict_from_jax_params
from scgrhc_torch.ops.kernels import conv_block as k1f
from scgrhc_torch.ops.nn import instance_norm_global
from scgrhc_torch.parallel.mesh import TIME_AXIS, Mesh
from test_torch_parallel import enable_x64, run_world

RTOL = 1e-9
L = 1024
C = 2
WORLDS = (2, 4)

WORKER = r"""
import os, pickle, sys
rank, io_dir, n = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm
comm.init_distributed("file://" + os.path.join(io_dir, "store"), n, rank, device="cpu",
                      timeout_s=60)
from scgrhc_torch.models import cp
from scgrhc_torch.models.convert import generator_from_state_dict
from scgrhc_torch.parallel.mesh import TIME_AXIS, make_mesh
with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
counts = {"halo": 0, "all_reduce": 0, "all_gather": 0}
def counted(key, fn):
    def wrapped(*a, **k):
        counts[key] += 1
        return fn(*a, **k)
    return wrapped
comm.neighbour_edges = counted("halo", comm.neighbour_edges)
comm.all_reduce_sum = counted("all_reduce", comm.all_reduce_sum)
comm.all_gather = counted("all_gather", comm.all_gather)
gen = generator_from_state_dict(inp["g_sd"]).eval()
mesh = make_mesh(axis=TIME_AXIS)
with torch.inference_mode():
    y = cp.apply_cp(gen, torch.from_numpy(inp["record"]), mesh)
with open(os.path.join(io_dir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump({"y": y.numpy(), "mesh": (mesh.size, mesh.rank, mesh.axis),
                 "counts": counts}, f)
comm.destroy()
"""


def _jax_params(c: int = C):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), jgen.init(jax.random.key(0), c))


def _two_blocks(x):
    """The record x (N, C, 2k) as two ranks hold it, with halos."""
    k = x.shape[-1] // 2
    z = torch.zeros_like(x[..., :1])
    return (torch.cat((z, x[..., :k], x[..., k:k + 1]), -1),
            torch.cat((x[..., k - 1:k], x[..., k:], z), -1))


def _jax_sharded(fn, n: int = 2):
    """fn(xs) under shard_map over an n-device time mesh, x sharded on time."""
    from jax import shard_map

    return shard_map(fn, mesh=jmesh.make_mesh(n, axis=TIME_AXIS),
                     in_specs=P(None, None, TIME_AXIS), out_specs=P(None, None, TIME_AXIS))


@pytest.mark.parametrize("cin,o,k", [(5, 64, 40), (64, 8, 3), (3, 4, 1)])
def test_k1f_plain_phases_match_jax_conv3_and_global_norm(cin, o, k):
    rng = np.random.default_rng(k)
    x = rng.random((2, cin, 2 * k))
    w = rng.uniform(-0.3, 0.3, (o, cin, 3))
    b = rng.uniform(-0.3, 0.3, o)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    parts = [k1f.conv_in_relu_part_plain(xh, tw, tb) for xh in _two_blocks(torch.from_numpy(x))]
    total = parts[0][1] + parts[1][1]
    got = torch.cat([k1f.conv_in_relu_apply_plain(c, total, 2 * k, torch.float64)
                     for c, _ in parts], -1).numpy()
    with enable_x64():
        def layer(xs):
            c = jcp._conv3(xs, jnp.asarray(w), jnp.asarray(b), TIME_AXIS, 2)
            return jnp.maximum(jcp._instance_norm_global(c, TIME_AXIS), 0.0)

        want = np.asarray(_jax_sharded(layer)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    # the sums are the interior columns' (sum, sum of squares)
    c0 = parts[0][0][..., 1:-1]
    np.testing.assert_allclose(parts[0][1].numpy(),
                               torch.stack((c0.sum(-1), (c0 * c0).sum(-1)), -1)
                               .reshape(-1, 2).numpy(), rtol=1e-12)


def test_instance_norm_global_matches_jax():
    """The attention gates' norm over two blocks, their sums added by the
    ``reduce`` hook, against ``_instance_norm_global`` on a 2-device time
    mesh; without a ``reduce`` it is the whole-record norm."""
    x = np.random.default_rng(3).random((1, 6, 50)) * 3 - 1
    with enable_x64():
        want = np.asarray(_jax_sharded(lambda xs: jcp._instance_norm_global(xs, TIME_AXIS))(
            jnp.asarray(x)))
        whole = np.asarray(jcp._instance_norm_global(jnp.asarray(x), None))
    blocks, bufs = torch.from_numpy(x).split(25, dim=-1), []
    for blk in blocks:
        instance_norm_global(blk, lambda buf: bufs.append(buf.clone()) or buf)
    total = bufs[0] + bufs[1]
    got = torch.cat([instance_norm_global(blk, lambda buf: total) for blk in blocks], -1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(instance_norm_global(torch.from_numpy(x)).numpy(), whole,
                               rtol=RTOL, atol=1e-12)


def test_apply_cp_refuses_a_length_that_does_not_divide_and_is_continuous_alone():
    gen = generator_from_jax_params(_jax_params()).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((C, 64)))
    with pytest.raises(ValueError, match="not divisible"):
        cp.apply_cp(gen, x[:, :63], Mesh(2, 0, TIME_AXIS))
    with torch.inference_mode():
        torch.testing.assert_close(cp.apply_cp(gen, x, Mesh(1, 0, TIME_AXIS)),
                                   cp.apply_continuous(gen, x[None]), rtol=0, atol=0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank outputs, and the inputs."""
    params = _jax_params()
    record = np.random.default_rng(2).random((C, L))
    inputs = {"g_sd": state_dict_from_jax_params(params), "record": record}
    out = {}
    for n in WORLDS:
        tmp = tmp_path_factory.mktemp(f"time{n}")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        procs = run_world(tmp, WORKER, n=n, args=(str(n),))
        for p in procs:
            assert p.returncode == 0, p.stdout[-4000:]
        out[n] = []
        for r in range(n):
            with open(tmp / f"out{r}.pkl", "rb") as f:
                out[n].append(pickle.load(f))
    return params, record, out


@pytest.fixture(scope="module")
def references(worlds):
    params, record, _ = worlds
    gen = generator_from_jax_params(params).eval()
    with torch.inference_mode():
        port = cp.apply_continuous(gen, torch.from_numpy(record)[None]).numpy()
    with enable_x64():
        jp = jax.tree.map(jnp.asarray, params)
        cont = np.asarray(jcp.apply_continuous(jp, jnp.asarray(record)[None]))
        sharded = {n: np.asarray(jcp.apply_cp(jp, jnp.asarray(record),
                                              jmesh.make_mesh(n, axis=TIME_AXIS)))
                   for n in WORLDS}
    return port, cont, sharded


@pytest.mark.parametrize("n", WORLDS)
def test_apply_cp_over_ranks_matches_jax_and_continuous(worlds, references, n):
    _, _, out = worlds
    port, cont, sharded = references
    np.testing.assert_allclose(sharded[n], cont, rtol=RTOL, atol=1e-12)
    for r, rec in enumerate(out[n]):
        assert rec["mesh"] == (n, r, TIME_AXIS)
        assert rec["y"].shape == (1, 1, L)
        np.testing.assert_array_equal(rec["y"], out[n][0]["y"])
    y = out[n][0]["y"]
    np.testing.assert_allclose(y, sharded[n], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(y, cont, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(y, port, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("n", WORLDS)
def test_apply_cp_collectives_per_forward(worlds, n):
    """20 halo exchanges (14 block convs, 3 up-convs, 3 pools), 23 norm
    all-reduces (14 K1f layers, 9 attention norms), 1 output gather."""
    _, _, out = worlds
    for rec in out[n]:
        assert rec["counts"] == {"halo": 20, "all_reduce": 23, "all_gather": 1}
