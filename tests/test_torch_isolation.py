"""The port stands alone: no scgrhc_torch module and not chip_smoke.py
imports JAX or the JAX package, or Orbax and the libraries under it
(tensorstore, zstandard, numcodecs), at run time or in its source, and
none imports pandas, sklearn or matplotlib at module level (the card's
machine has none of them)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "scgrhc_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import scgrhc_torch
names = [m.name for m in pkgutil.walk_packages(scgrhc_torch.__path__, "scgrhc_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "scgrhc", "pandas", "sklearn", "matplotlib",
                                    "orbax", "tensorstore", "zstandard", "numcodecs"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_pull_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "scgrhc_torch.pipeline.serve" in res["imported"]
    assert "scgrhc_torch.ops.kernels.conv_block" in res["imported"]
    assert "scgrhc_torch.train.orbax_io" in res["imported"]
    for name in ("scgrhc_torch.ops.kernels.dsp", "scgrhc_torch.pipeline.run",
                 "scgrhc_torch.select.run", "scgrhc_torch.summary",
                 "scgrhc_torch.pipeline.sweep", "scgrhc_torch.pipeline.report",
                 "scgrhc_torch.pipeline.plots", "scgrhc_torch.pipeline.demo",
                 "scgrhc_torch.parallel.comm", "scgrhc_torch.parallel.mesh",
                 "scgrhc_torch.parallel.dp"):
        assert name in res["imported"]
    assert res["bad"] == []


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|scgrhc(?!_torch)|orbax|tensorstore|zstandard"
    r"|numcodecs)\b"
    r"|import_module\(\s*['\"](?:jax|scgrhc(?!_torch)|orbax|tensorstore|zstandard|numcodecs)",
    re.MULTILINE,
)


def test_port_sources_import_no_jax_or_scgrhc():
    assert len(PORT_FILES) > 20
    hits = {
        str(p.relative_to(ROOT)): _IMPORT.findall(p.read_text())
        for p in PORT_FILES
    }
    assert {k: v for k, v in hits.items() if v} == {}


def test_scan_pattern_catches_what_it_must():
    bad = ["import jax", "from scgrhc.io import wfdb", "    import scgrhc",
           "importlib.import_module('scgrhc.core')", "import orbax.checkpoint as ocp",
           "    import tensorstore as ts", "from zstandard import ZstdDecompressor",
           "import numcodecs", "importlib.import_module('tensorstore')"]
    good = ["from scgrhc_torch.io import wfdb", "import scgrhc_torch",
            "# see scgrhc/ops/pallas/dsp.py", "from scgrhc_torch.train import orbax_io",
            "from scgrhc_torch.native import zstd"]
    assert all(_IMPORT.search(s) for s in bad)
    assert not any(_IMPORT.search(s) for s in good)


# module level: an unindented import; a lazy import inside a function or a
# try (train/run.py's matplotlib) is allowed
_HOST_ONLY = re.compile(r"^(?:from|import)\s+(?:pandas|sklearn|matplotlib)\b", re.MULTILINE)


def test_port_sources_import_no_pandas_sklearn_matplotlib_at_module_level():
    hits = {str(p.relative_to(ROOT)): _HOST_ONLY.findall(p.read_text()) for p in PORT_FILES}
    assert {k: v for k, v in hits.items() if v} == {}
    assert _HOST_ONLY.search("import pandas as pd") and _HOST_ONLY.search("from sklearn import x")
    assert not _HOST_ONLY.search("        import matplotlib")
    assert not _HOST_ONLY.search("import pandasx")
