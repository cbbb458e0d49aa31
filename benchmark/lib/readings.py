"""The readings that the limits of ``correct`` are set from: the program's
numbers against the reference, the control's (the reference computed with
TF32 products, in the program's place) and the numbers that a broken step
gives (:mod:`benchmark.lib.faults`).  Used by ``calibrate.py`` and the
control test; a measured run never imports it."""

from __future__ import annotations

import statistics

from benchmark.lib import compare, faults, gpu


def diagnose(res, ref, w0) -> list[dict]:
    """Where the worst leaf lies, and the median leaf's gaps: what the
    limits' look reads besides the compared numbers."""
    out = []
    for m in ("g", "d"):
        g = compare.leaf_gaps(res["first_moment"][m], ref["first_moment"][m])
        worst = max(g, key=g.get)
        moved = compare.moved_leaves(ref["first_moment"][m])
        u = compare.leaf_gaps({k: res["weights"][m][k] - w0[m][k] for k in moved},
                              {k: ref["weights"][m][k] - w0[m][k] for k in moved})
        out += [{"name": f"grad_worst_leaf.{m}", "value": f"{worst} {g[worst]:.3g}"},
                {"name": f"grad_median_leaf.{m}", "value": statistics.median(g.values())},
                {"name": f"update_median_leaf.{m}", "value": statistics.median(u.values())},
                {"name": f"update_worst_leaf.{m}", "value": max(u, key=u.get)}]
    return out


def train_readings(mod, run, kinds):
    """{kind: checks} for one seed of a training cell: the program's
    numbers (always), with each fault of ``kinds`` planted, and the
    control's, each against the reference."""
    out, results = {}, {}
    for kind in ["program"] + [k for k in kinds if k in faults.TRAIN]:
        with faults.train_fault(kind):
            drv = mod.Driver(run)
            drv.setup()
        results[kind] = drv.program_result()
        drv.free()
    gpu.tf32(False)  # the reference in the configuration's float32
    ref = drv.reference_result()  # the inputs are the seed's, whichever run made them
    if "control" in kinds:
        gpu.tf32(True)
        try:
            results["control"] = drv.reference_result()
        finally:
            gpu.tf32(False)
    w0 = mod.host(drv.w0)
    for kind, res in results.items():
        out[kind] = [{"name": n, "value": v} for n, v in mod.numbers(res, ref, w0).items()]
        out[kind] += diagnose(res, ref, w0)
    return out

