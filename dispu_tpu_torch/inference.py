"""Whole-cloud upsampling through batched patches (counterpart of
``inference.py``).

normalize each cloud → FPS seeds → kNN patches (k = patch size; the kNN
kernel on the card) → per-patch normalization → the generator in chunks
of ``patch_batch`` patches (the count padded with copies of the first
patch), ``num_passes`` chained passes a chunk (1 at 4×, 2 at 16×) →
un-normalize the patches → merge FPS down to n·final_ratio points a cloud
(exact, or with ``merge_fps='bucketed'`` by Morton buckets) → un-normalize
the clouds.  :meth:`PatchUpsampler.pipeline` is that whole function of
the clouds' tensor; ``upsample_many`` runs it on B same-size clouds at
once, ``upsample`` is its one-cloud case, and ``serving.export_upsampler``
traces it.  The stages are spans of ``utils.tracing`` (``serve.request``,
the copies in and out included; ``serve.prepare``; ``serve.generate``
with a ``serve.pass`` for each pass of each chunk; ``serve.merge``),
which record only while a profiler or ``tracing.recording()`` does.  The turbo serving flags of
``dispu.py --turbo`` are a ``GeneratorConfig`` and an ``InferenceConfig``
(``cli.build_config``).

Patch-parallel serving (``mesh``): every process runs the same request.
``patch_batch`` is rounded up to a multiple of the mesh's data axis; every
process prepares the patches (the same in each), runs the generator on its
rows of each chunk, and the predictions are all-gathered, so that every
process merges all of them.  This one eager path stands for both of the
JAX package's mesh paths, its staged one and its single-program one
(``mesh_fused``): ``upsample`` and ``upsample_many`` both take it, and
``serving.export_upsampler(mesh=...)`` traces it, with the rank as the
program's input.  The merge is not sharded (the JAX package does not pass
its mesh to the merge either).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dispu_tpu_torch.config import (GeneratorConfig, InferenceConfig,
                                    check_supported)
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.kernels import pin_f32
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.ops.geometry import normalize_point_cloud
from dispu_tpu_torch.ops.knn import knn
from dispu_tpu_torch.ops.sampling import (farthest_point_sample,
                                          farthest_point_sample_bucketed)
from dispu_tpu_torch.parallel.mesh import (all_gather_rows, data_rank,
                                           data_size)
from dispu_tpu_torch.utils.tracing import span


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA request without a card raises rather
    than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def plan_counts(n: int, inf_cfg: InferenceConfig):
    """(seed_num, out_num) for an ``n``-point input cloud: seeds = n /
    patch size · oversampling ratio, at least 1."""
    seed_num = max(
        int(n / inf_cfg.patch_num_point * inf_cfg.patch_num_ratio), 1
    )
    return seed_num, n * inf_cfg.final_ratio


def _take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``points`` at (b, m) indices → (b, m, c)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, idx)


class PatchUpsampler:
    """Upsample whole clouds with the Dis-PU generator.

    variables: a flax ``{'params', 'batch_stats'}`` tree (nested dicts of
    arrays) to load, or None for the port's own init from ``seed``.
    device: 'cuda' by default; 'cpu' runs the kernels' plain versions.
    impl: 'auto', 'cuda' or 'torch' for the kNN, FPS and attention
    kernels (see ``dispu_tpu_torch.kernels``).  mesh: patch-parallel over
    this mesh (module docstring).
    """

    def __init__(self, variables=None,
                 gen_cfg: GeneratorConfig = GeneratorConfig(),
                 inf_cfg: InferenceConfig = InferenceConfig(),
                 device="cuda", impl: str = "auto", seed: int = 0,
                 mesh=None):
        check_supported(gen_cfg, inf_cfg)
        self.device = resolve_device(device)
        pin_f32()
        self.gen_cfg, self.inf_cfg, self.impl = gen_cfg, inf_cfg, impl
        self.mesh = mesh
        # chunks tile the data axis, so every process has as many rows
        bs, w = inf_cfg.patch_batch, 1 if mesh is None else data_size(mesh)
        self.patch_batch = -(-bs // w) * w
        # chained passes of the generator: 4× → 1, 16× → 2
        self.num_passes = max(
            1, round(math.log(inf_cfg.final_ratio, inf_cfg.step_ratio)))
        model = DisPUGenerator(gen_cfg, impl=impl, seed=seed,
                               dtype=inf_cfg.compute_dtype)
        if variables is not None:
            from_flax_variables(model, variables)
        self.model = model.to(self.device).eval()

    # ---------------------------------------------------------------- stages

    def prepare(self, pcs_n: torch.Tensor, seed_num: int):
        """FPS seeds, kNN patches and per-patch normalization of B
        normalized (B, n, 3) clouds → (patches (B·s, p, 3), centroid
        (B·s, 1, 3), furthest (B·s, 1, 1), seed indices (B, s)); the
        patches of cloud v are rows v·s to v·s + s − 1."""
        b = pcs_n.shape[0]
        p = self.inf_cfg.patch_num_point
        with span("serve.prepare"):
            seeds_idx = farthest_point_sample(seed_num, pcs_n,
                                              impl=self.impl)
            _, idx = knn(p, pcs_n, _take(pcs_n, seeds_idx), impl=self.impl)
            patches = _take(pcs_n, idx.reshape(b, -1)).reshape(
                b * seed_num, p, 3)
            patches, centroid, furthest = normalize_point_cloud(patches)
        return patches, centroid, furthest, seeds_idx

    def chunks(self, patches: torch.Tensor):
        """The patches padded to a multiple of ``patch_batch`` (rounded up
        to the data axis under a mesh) with copies of the first patch, as
        a list of (patch_batch, p, 3) chunks."""
        bs = self.patch_batch
        pad = (-patches.shape[0]) % bs
        if pad:
            filler = patches[:1].expand((pad,) + patches.shape[1:])
            patches = torch.cat([patches, filler], dim=0)
        return list(torch.split(patches, bs, dim=0))

    def generate(self, patches: torch.Tensor,
                 rank: torch.Tensor | None = None) -> torch.Tensor:
        """(s, p, 3) normalized patches → (s, p·r^num_passes, 3) fine
        points: each chunk goes through the generator ``num_passes`` times,
        each pass taking the previous pass's fine points.  Under a mesh
        each process runs its rows of every chunk, and one all-gather
        brings every process all of them.  ``rank``: this process's data
        rank as a 0-d int64 tensor (an exported program's input, where a
        Python int would be a constant of the trace), the mesh's by
        default; its rows are taken by ``index_select``."""
        with span("serve.generate"):
            chunks = self.chunks(patches)
            if self.mesh is not None:
                if rank is None:
                    rank = torch.tensor(data_rank(self.mesh),
                                        device=patches.device)
                # __init__ rounds patch_batch up to a multiple of the axis
                per = self.patch_batch // data_size(self.mesh)
                rows = torch.arange(per, device=patches.device) + rank * per
                chunks = [c.index_select(0, rows) for c in chunks]
            preds = []
            for pred in chunks:
                for _ in range(self.num_passes):
                    with span("serve.pass"):
                        pred = self.model(pred)[1]
                preds.append(pred)
            if self.mesh is None:
                return torch.cat(preds, dim=0)[: patches.shape[0]]
            # (W, chunks, rows, ...) → chunk by chunk, each in rank order
            every = all_gather_rows(torch.stack(preds), self.mesh)
            return every.transpose(0, 1).flatten(0, 2)[: patches.shape[0]]

    def merge(self, points: torch.Tensor, out_num: int) -> torch.Tensor:
        """Merge FPS of B clouds' candidates, one FPS call for all B (the
        JAX package's ``impl='batch'``): (B, N, 3) → (B, out_num, 3).
        With ``merge_fps='bucketed'`` and ``out_num ≥ merge_fps_buckets``
        the bucketed FPS instead, every bucket of the B clouds in one
        ``fps_bucketed`` call (the JAX package loops over the clouds),
        ranked by argsort over 10-bit Morton codes or, with
        ``merge_fps_rank='radix'``, by the counting rank over 4-bit ones."""
        inf = self.inf_cfg
        with span("serve.merge"):
            if (inf.merge_fps == "bucketed"
                    and out_num >= inf.merge_fps_buckets):
                rank = inf.merge_fps_rank  # 'radix' ranks 4-bit codes
                idx = farthest_point_sample_bucketed(
                    out_num, points, n_buckets=inf.merge_fps_buckets,
                    impl=self.impl, rank_impl=rank,
                    bits=4 if rank == "radix" else 10)
            else:
                impl = "batch" if self.impl == "auto" else self.impl
                idx = farthest_point_sample(out_num, points, impl=impl)
            return _take(points, idx)

    def pipeline(self, pcs: torch.Tensor,
                 rank: torch.Tensor | None = None) -> torch.Tensor:
        """(B, n, 3) same-size f32 clouds on the device → (B,
        n·final_ratio, 3): normalize, :meth:`prepare`, :meth:`generate`
        (``rank`` as it takes it), un-normalize the patches, :meth:`merge`,
        un-normalize the clouds.  The one function that live requests run
        and that an export traces."""
        b, n, _ = pcs.shape
        seed_num, out_num = plan_counts(n, self.inf_cfg)
        pcs_n, centroid, furthest = normalize_point_cloud(pcs)
        patches, p_centroid, p_furthest, _ = self.prepare(pcs_n, seed_num)
        pred = self.generate(patches, rank) * p_furthest + p_centroid
        out = self.merge(pred.reshape(b, -1, 3), out_num)
        return out * furthest + centroid

    # ------------------------------------------------------------------- API

    @torch.inference_mode()
    def upsample_many(self, pcs) -> np.ndarray:
        """(B, n, 3) same-size clouds → (B, n·final_ratio, 3) (numpy).

        As in the JAX package, cloud v's output is not bit-identical to
        ``upsample(pcs[v])`` for B > 1: its patches share generator chunks
        with the other clouds' and the padding differs, which moves the
        f32 round-off of each chunk's products."""
        pcs = np.asarray(pcs, np.float32)[:, :, :3]
        with span("serve.request"):
            return self.pipeline(torch.from_numpy(pcs).to(self.device)
                                 ).cpu().numpy()

    def upsample(self, pc) -> np.ndarray:
        """(n, 3) cloud → (n·final_ratio, 3) upsampled cloud (numpy)."""
        return self.upsample_many(np.asarray(pc, np.float32)[None, :, :3])[0]
