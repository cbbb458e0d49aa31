"""Pipeline parallelism: 2-stage microbatched generator inference over the
``stage`` axis, the PyTorch counterpart of ``scgrhc.parallel.pp``.

The attention U-Net has one natural cut: after the bottleneck.  Stage 0
(rank 0 of the axis) runs the encoder (enc1..enc3 and the bottleneck,
:meth:`Generator.encode`: 8 K1f launches a microbatch); stage 1 runs the
decoder (up, attention and dec x3, and the final 1x1 conv,
:meth:`Generator.decode`: 6 K1f launches).  Between them travels the
U-Net's skip set (e1, e2, e3, b), packed into one flat buffer a microbatch
(:func:`_pack`): 715,648 values a window at T = 750, 2.86 MB in float32.

Schedule: the 1F pipeline.  The batch is split into M microbatches; stage
0 encodes microbatch i and starts sending it (``comm.send``), then encodes
i + 1 while the send runs; stage 1 posts the receive of i + 1 before it
decodes i.  Both stages are busy on every interior step, and the bubble is
(S - 1) / (M + S - 1).  Stage 1's outputs are broadcast to stage 0, so the
result is on both ranks.  Gloo's send and receive take CPU tensors only, so
under gloo (ranks on the CPU, or sharing one card) a buffer on the card
goes through pinned host memory; under NCCL it goes from card to card.

``scgrhc`` caches one compiled ``shard_map`` program per schedule and
shapes (``_compiled_run``); PyTorch runs eagerly and compiles nothing, so
the port has no such cache.  Weights are replicated on both stages.

Scope: inference, as in ``scgrhc``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scgrhc_torch.models.quant import QuantGenerator
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import Mesh, make_mesh

STAGE_AXIS = "stage"
N_STAGES = 2  # the U-Net's one natural cut (module doc)


def make_pp_mesh() -> Mesh:
    """The 1-D ``stage`` mesh over the world, which must have N_STAGES
    ranks."""
    if comm.process_count() < N_STAGES:
        raise ValueError(f"pipeline needs {N_STAGES} ranks, have {comm.process_count()}")
    return make_mesh(N_STAGES, STAGE_AXIS)


def _skip_shapes(t: int, mb: int, widths=(64, 128, 256, 512)):
    """Shapes of the inter-stage payload for segment length ``t``: the
    encoder lengths follow T → T-2 → T-4 → T-6 (MaxPool k3 s1), which must
    stay positive; ``widths`` are the (e1, e2, e3, bottleneck) channel
    counts (:func:`_skip_widths`)."""
    if t <= 6:
        raise ValueError(f"segment length {t} too short for the U-Net (need > 6)")
    w1, w2, w3, wb = widths
    return ((mb, w1, t), (mb, w2, t - 2), (mb, w3, t - 4), (mb, wb, t - 6))


def _skip_widths(gen):
    """(e1, e2, e3, bottleneck) out-channel widths read off the generator."""
    return tuple(getattr(gen, name).convs[1].weight.shape[0]
                 for name in ("enc1", "enc2", "enc3", "bottleneck"))


def _pack(acts):
    """(e1, e2, e3, b) → (mb, P) flat buffer for one send."""
    mb = acts[0].shape[0]
    return torch.cat([a.reshape(mb, -1) for a in acts], dim=1)


def _unpack(buf, shapes):
    out, off = [], 0
    for s in shapes:
        n = s[1] * s[2]
        out.append(buf[:, off:off + n].reshape(s))
        off += n
    return tuple(out)


def pipeline_infer(gen, scg, mesh: Mesh, microbatch: int = 8):
    """Pipeline-parallel eval forward over ``mesh``, the 2-rank stage axis:
    scg (B, C, T), the same on both ranks → (B, 1, T) on both, in the
    ``final`` weights' dtype.  Numerically ``gen(scg)`` in eval mode: the
    stage bodies are ``encode`` and ``decode``.  B is padded up to a
    multiple of ``microbatch`` (clamped to B) with zero rows, computed and
    dropped.  A collective over the axis."""
    if mesh.size != N_STAGES:
        raise ValueError(
            f"mesh axis {mesh.axis!r} has size {mesh.size}; the U-Net pipeline is "
            f"{N_STAGES}-stage (one cut, at the bottleneck)"
        )
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if isinstance(gen, QuantGenerator):
        raise ValueError(
            "int8-quantized generators are unsupported under pipeline parallelism (the stage "
            "bodies are Generator.encode/decode); use the single-rank int8 path"
        )
    b_in, _, t = scg.shape
    if b_in == 0:
        raise ValueError("empty batch: scg has 0 rows")
    mb = min(microbatch, b_in)
    n_mb = -(-b_in // mb)
    shapes = _skip_shapes(t, mb, _skip_widths(gen))
    dev = next(gen.parameters()).device
    x = F.pad(scg.to(dev, gen.dtype), (0, 0, 0, 0, 0, n_mb * mb - b_in))
    out = torch.zeros((n_mb * mb, 1, t), dtype=gen.final.weight.dtype, device=dev)
    with torch.inference_mode():
        if mesh.rank == 0:
            sent = None
            for i in range(n_mb):
                buf = _pack(gen.encode(x[i * mb:(i + 1) * mb]))
                if sent is not None:
                    sent()
                sent = comm.send(buf, 1, mesh.group)
            sent()
        else:
            size = sum(s[1] * s[2] for s in shapes)
            bufs = [torch.empty((mb, size), dtype=gen.dtype, device=dev) for _ in range(2)]
            recv = comm.recv(bufs[0], 0, mesh.group)
            for i in range(n_mb):
                got = recv()
                if i + 1 < n_mb:
                    recv = comm.recv(bufs[(i + 1) % 2], 0, mesh.group)
                xi = x[i * mb:(i + 1) * mb]
                out[i * mb:(i + 1) * mb] = gen.decode(xi, *_unpack(got, shapes))
        comm.broadcast(out, src=1, group=mesh.group)
    return out[:b_in]
