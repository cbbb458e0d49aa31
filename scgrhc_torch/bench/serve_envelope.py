"""The f32 envelope of the generator's forward on a long record: the card's
kernel path (K1f), the card's plain path (cuDNN, TF32 off) and the CPU's f32
forward, each against the CPU's float64 forward of the same windows.

    python3 scgrhc_torch/bench/serve_envelope.py

Random weights (seed 1234), a 600-s synthetic record (seed 3) framed and
normalized as serving does, at T = 750 and 1500.  Prints, for each path,
the largest absolute error over the record, the median of the per-window
largest errors, the windows where the kernel path's error is largest, and
the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from scgrhc_torch.core import paths  # noqa: E402
from scgrhc_torch.core.device import resolve_device  # noqa: E402
from scgrhc_torch.io.catalog import read_record_digital  # noqa: E402
from scgrhc_torch.models.generator import Generator, plain_block  # noqa: E402
from scgrhc_torch.ops.kernels.dsp import normalize_windows_plain  # noqa: E402
from scgrhc_torch.parallel.stream import calibrate, frame_record  # noqa: E402
from scgrhc_torch.utils.synth import make_synthetic_database  # noqa: E402

CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_envelope: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = resolve_device("cuda")
    root = tempfile.mkdtemp(prefix="serve_envelope_")
    db = make_synthetic_database(os.path.join(root, "db"), n_records=1, duration_s=600.0, seed=3,
                                 flatline_in_first=False)
    paths.set_data_path(os.path.dirname(db))
    adc, gain, base, sentinel = read_record_digital("SYN000", CHANNELS)
    phys = calibrate(torch.from_numpy(np.ascontiguousarray(adc.T)),
                     *(torch.from_numpy(v) for v in (gain, base, sentinel)))
    gen = Generator(len(CHANNELS), torch.Generator().manual_seed(1234)).eval()
    g64 = Generator(len(CHANNELS), torch.Generator().manual_seed(1234)).double().eval()
    card_gen = Generator(len(CHANNELS), torch.Generator().manual_seed(1234)).to(dev).eval()
    print(f"card: {card}")
    for t in (750, 1500):
        w = normalize_windows_plain(frame_record(phys, t).contiguous())
        with torch.inference_mode():
            ref = g64(w.double())[:, 0].numpy()
            out = {"kernels": card_gen(w.to(dev))[:, 0].cpu().numpy(),
                   "card plain": card_gen(w.to(dev), block=plain_block)[:, 0].cpu().numpy(),
                   "cpu": gen(w)[:, 0].numpy()}
        per = {k: np.abs(v - ref).max(axis=1) for k, v in out.items()}
        print(f"T={t}, {w.shape[0]} windows, largest abs error against float64 (median of the "
              f"per-window largest): " + ", ".join(
                  f"{k} {p.max():.3g} ({np.median(p):.3g})" for k, p in per.items()))
        for i in np.argsort(per["kernels"])[::-1][:3]:
            print(f"  window {i}: " + ", ".join(f"{k} {p[i]:.3g}" for k, p in per.items())
                  + f"; its f64 output spans [{ref[i].min():.3f}, {ref[i].max():.3f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
