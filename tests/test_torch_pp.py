"""The port's stage axis (``scgrhc_torch.parallel.pp``) against
``scgrhc.parallel.pp``.

``pipeline_infer`` in a 2-rank gloo world on the CPU (a ``file://``
store), float64, against ``scgrhc``'s ``pipeline_infer`` on a 2-device
stage mesh (the conftest's virtual devices, float64) and against the
port's own eval forward at world size 1, at the f64 oracle tier's rtol
1e-9 (PARITY.md "Float64 oracle tier"): a ragged batch (B = 5 at
microbatch 2: three microbatches, one padded row), a clamped microbatch
(B = 3 at microbatch 8: one microbatch), and a bf16 generator (its skips
travel in bf16) against the port's bf16 eval forward, equal bit for bit.
Both ranks return the result.  The helpers (``_skip_shapes``,
``_skip_widths``, ``_pack``, ``_unpack``) equal ``scgrhc``'s, and every
refusal of ``scgrhc/parallel/pp.py:119-133`` is the port's too.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.models import generator as jgen
from scgrhc.parallel import pp as jpp
from scgrhc_torch.models.convert import generator_from_jax_params, state_dict_from_jax_params
from scgrhc_torch.parallel import pp
from scgrhc_torch.parallel.mesh import Mesh
from test_torch_parallel import enable_x64, run_world

RTOL = 1e-9
C, T = 2, 24
CASES = ((5, 2), (3, 8))  # (B, microbatch): ragged, clamped

WORKER = r"""
import os, pickle, sys
rank, io_dir = int(sys.argv[1]), sys.argv[2]
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm
comm.init_distributed("file://" + os.path.join(io_dir, "store"), 2, rank, device="cpu",
                      timeout_s=60)
from scgrhc_torch.models.convert import generator_from_state_dict
from scgrhc_torch.parallel import pp
with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
gen = generator_from_state_dict(inp["g_sd"]).eval()
mesh = pp.make_pp_mesh()
out = {"mesh": (mesh.size, mesh.rank, mesh.axis), "f64": [], "bf16": []}
for x, mb in inp["cases"]:
    out["f64"].append(pp.pipeline_infer(gen, torch.from_numpy(x), mesh, microbatch=mb).numpy())
bf16 = generator_from_state_dict(inp["g_sd"]).eval().float().cast(torch.bfloat16)
x, mb = inp["cases"][0]
out["bf16"] = pp.pipeline_infer(bf16, torch.from_numpy(x).float(), mesh, microbatch=mb).numpy()
with open(os.path.join(io_dir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
comm.destroy()
"""


def _jax_params():
    return jax.tree.map(lambda a: np.asarray(a, np.float64), jgen.init(jax.random.key(0), C))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = _jax_params()
    rng = np.random.default_rng(1)
    cases = [(rng.random((b, C, T)), mb) for b, mb in CASES]
    tmp = tmp_path_factory.mktemp("pp")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"g_sd": state_dict_from_jax_params(params), "cases": cases}, f)
    procs = run_world(tmp, WORKER)
    for p in procs:
        assert p.returncode == 0, p.stdout[-4000:]
    ranks = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return params, cases, ranks


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pipeline_infer_matches_jax_and_the_eval_forward(world, case):
    params, cases, ranks = world
    x, mb = cases[case]
    gen = generator_from_jax_params(params).eval()
    with torch.inference_mode():
        want = gen(torch.from_numpy(x)).numpy()
    with enable_x64():
        jp = jax.tree.map(jnp.asarray, params)
        ref = np.asarray(jpp.pipeline_infer(jp, jnp.asarray(x), jpp.make_pp_mesh(),
                                            microbatch=mb))
    for r, rec in enumerate(ranks):
        assert rec["mesh"] == (2, r, pp.STAGE_AXIS)
        got = rec["f64"][case]
        assert got.shape == (x.shape[0], 1, T)
        np.testing.assert_array_equal(got, ranks[0]["f64"][case])
    np.testing.assert_allclose(ranks[0]["f64"][case], ref, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(ranks[0]["f64"][case], want, rtol=RTOL, atol=1e-12)


def test_pipeline_infer_bf16_equals_the_bf16_eval_forward(world):
    params, cases, ranks = world
    x, _ = cases[0]
    gen = generator_from_jax_params(params).eval().float().cast(torch.bfloat16)
    with torch.inference_mode():
        want = gen(torch.from_numpy(x).float()).numpy()
    for rec in ranks:
        np.testing.assert_array_equal(rec["bf16"], want)


def test_pipeline_helpers_match_jax():
    params = _jax_params()
    gen = generator_from_jax_params(params)
    assert pp._skip_widths(gen) == jpp._skip_widths(params) == (64, 128, 256, 512)
    assert pp._skip_shapes(T, 3) == jpp._skip_shapes(T, 3)
    assert pp._skip_shapes(750, 1, pp._skip_widths(gen))[3] == (1, 512, 744)
    assert sum(s[1] * s[2] for s in pp._skip_shapes(750, 1)) == 715_648
    rng = np.random.default_rng(0)
    acts = [rng.random(s) for s in pp._skip_shapes(T, 3)]
    buf = pp._pack([torch.from_numpy(a) for a in acts])
    with enable_x64():
        want = np.asarray(jpp._pack([jnp.asarray(a) for a in acts]))
    np.testing.assert_array_equal(buf.numpy(), want)
    for got, want in zip(pp._unpack(buf, pp._skip_shapes(T, 3)), acts):
        np.testing.assert_array_equal(got.numpy(), want)
    assert pp.STAGE_AXIS == jpp.STAGE_AXIS and pp.N_STAGES == jpp.N_STAGES


def test_pipeline_infer_refusals():
    """scgrhc/parallel/pp.py:119-133: a stage axis of other than 2 ranks,
    microbatch < 1, an int8 generator, an empty batch, T <= 6; and no
    stage mesh at world size 1."""
    gen = generator_from_jax_params(_jax_params()).eval()
    x = torch.rand(4, C, T, dtype=torch.float64)
    two = Mesh(2, 0, pp.STAGE_AXIS)
    with pytest.raises(ValueError, match="2-stage"):
        pp.pipeline_infer(gen, x, Mesh(1, 0, pp.STAGE_AXIS))
    with pytest.raises(ValueError, match="microbatch"):
        pp.pipeline_infer(gen, x, two, microbatch=0)
    with pytest.raises(ValueError, match="int8"):
        pp.pipeline_infer(gen.float().cast(torch.int8), x.float(), two)
    with pytest.raises(ValueError, match="empty batch"):
        pp.pipeline_infer(gen, x[:0], two)
    with pytest.raises(ValueError, match="too short"):
        pp.pipeline_infer(gen, x[..., :6], two)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pp.make_pp_mesh()
