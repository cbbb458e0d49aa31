"""Experiment configuration (the port's copy of ``scgrhc.core.params``).

Reads the same per-experiment ``params.json`` files as the reference
(reference: paramutil.py:5-33).  Required keys match the reference
exactly; a missing key raises ``KeyError``.  The optional extension keys
of ``scgrhc`` are read with the same defaults, so one ``params.json``
configures both packages; the port's serving slice reads only
``in_channels``, ``segment_size`` and the path keys, and later slices
consume the rest.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any

from scgrhc_torch.io.catalog import SAMPLE_FREQ


class Params:
    """Typed view over one experiment's ``params.json``.

    Attribute surface mirrors the reference's ``paramutil.Params``
    (reference: paramutil.py:6-29): every path key is joined onto
    ``dir_path``.
    """

    REQUIRED_KEYS = (
        "in_channels",
        "chamber",
        "segment_size",
        "batch_size",
        "dir_path",
        "train_path",
        "valid_path",
        "test_path",
        "checkpoint_dir_path",
        "comparison_dir_path",
        "pred_top_dir_path",
        "pred_rand_dir_path",
        "alpha",
        "beta1",
        "beta2",
        "n_critic",
        "lambda_gp",
        "lambda_aux",
        "total_epochs",
        "min_RHC",
        "use_global_min_max",
    )

    def __init__(self, path: str):
        self.path = path
        self.data = self.init_json(path)
        d = self.data
        self.in_channels = d["in_channels"]
        self.chamber = d["chamber"]
        self.segment_size = d["segment_size"]
        self.batch_size = d["batch_size"]
        self.dir_path = d["dir_path"]
        self.train_path = os.path.join(self.dir_path, d["train_path"])
        self.valid_path = os.path.join(self.dir_path, d["valid_path"])
        self.test_path = os.path.join(self.dir_path, d["test_path"])
        self.checkpoint_dir_path = os.path.join(self.dir_path, d["checkpoint_dir_path"])
        self.comparison_dir_path = os.path.join(self.dir_path, d["comparison_dir_path"])
        self.pred_top_dir_path = os.path.join(self.dir_path, d["pred_top_dir_path"])
        self.pred_rand_dir_path = os.path.join(self.dir_path, d["pred_rand_dir_path"])
        self.alpha = d["alpha"]
        self.beta1 = d["beta1"]
        self.beta2 = d["beta2"]
        self.n_critic = d["n_critic"]
        self.lambda_gp = d["lambda_gp"]
        self.lambda_aux = d["lambda_aux"]
        self.total_epochs = d["total_epochs"]
        self.min_RHC = d["min_RHC"]
        self.use_global_min_max = d["use_global_min_max"]
        # --- extension keys (optional, defaulted as in scgrhc) ---
        profile = d.get("train_profile", "reference")
        if profile not in ("reference", "fast"):
            raise ValueError(
                f"train_profile must be 'reference' or 'fast', got {profile!r}"
            )
        self.train_profile = profile
        d = dict(d)  # profile defaults must not mutate the caller's dict
        if profile == "fast":
            for k, v in (
                ("train_dtype", "bfloat16"),
                ("rng_impl", "rbg"),
                ("reuse_pred", True),
                ("critic_fuse", "2b"),
                ("shape_bucket", True),
                ("channel_bucket", True),
                ("checkpoint_async", True),
                ("plot_async", True),
            ):
                d.setdefault(k, v)
        # "seed": null reproduces the reference's unseeded behavior
        # (recordutil.py:191-192): a fresh random seed per run.
        seed = d.get("seed", 0)
        self.unseeded = seed is None
        if self.unseeded:
            seed = self._draw_seed()
        self.seed = seed
        self.dtype = d.get("dtype", "float32")
        if self.dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"dtype must be 'float32', 'bfloat16' or 'int8', got {self.dtype!r}"
            )
        self.eval_batch = d.get("eval_batch", 1024)
        self.checkpoint_backend = d.get("checkpoint_backend", "reference")
        self.checkpoint_async = d.get("checkpoint_async", False)
        self.plot_async = d.get("plot_async", False)
        self.train_mode = d.get("train_mode", "epoch")
        self.data_backend = d.get("data_backend", "host")
        self.fix_g_adversarial = d.get("fix_g_adversarial", False)
        self.train_dtype = d.get("train_dtype", "float32")
        if self.train_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"train_dtype must be 'float32' or 'bfloat16', got {self.train_dtype!r}"
            )
        self.critic_fuse = d.get("critic_fuse", "off")
        self.remat = d.get("remat", False)
        self.conv_backend = d.get("conv_backend", "xla")
        self.critic_backend = d.get("critic_backend", "xla")
        self.rng_impl = d.get("rng_impl", "threefry")
        self.reuse_pred = d.get("reuse_pred", False)
        self.eval_stack = d.get("eval_stack", 8)
        self.shape_bucket = d.get("shape_bucket", False)
        self.channel_bucket = d.get("channel_bucket", False)
        self.loader_backend = d.get("loader_backend", "native")

    @staticmethod
    def _draw_seed() -> int:
        """One random seed for an unseeded run, agreed across the ranks.

        Under a process group every rank adopts rank 0's draw, or the
        replicas' inits and shuffles would quietly diverge; the group
        (``torch.distributed``, which ``scgrhc_torch.parallel.comm.
        init_distributed`` starts) must therefore exist before
        ``Params(...)``.  A launch whose environment names a world
        (``WORLD_SIZE`` > 1) while no group is up raises instead of letting
        each process draw its own seed."""
        import torch.distributed as dist

        seed = random.SystemRandom().randrange(2**31)
        if dist.is_initialized():
            box = [seed]
            dist.broadcast_object_list(box, src=0)
            return int(box[0])
        world = os.environ.get("WORLD_SIZE", "1")
        if world.isdigit() and int(world) > 1:
            raise RuntimeError(
                f'"seed": null on a multi-process launch (WORLD_SIZE={world}) requires '
                "scgrhc_torch.parallel.comm.init_distributed() before Params(...): no "
                "process group is up, so each process would draw a different seed and "
                "the replicated state would quietly diverge."
            )
        return seed

    @staticmethod
    def init_json(path: str) -> dict[str, Any]:
        with open(path, "r") as f:
            return json.load(f)

    @property
    def segment_samples(self) -> int:
        """Segment length in samples (segment_size seconds x 500 Hz)."""
        return int(self.segment_size * SAMPLE_FREQ)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Params({self.path!r})"
