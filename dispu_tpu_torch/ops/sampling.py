"""Farthest-point sampling, row gathers and the training input's
nonuniform draw (counterpart of ``ops/sampling.py``)."""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels import fps as _fps
from dispu_tpu_torch.kernels import fps_chunked as _fps_chunked


def fps_kernel_for(n: int) -> str:
    """The kernel that takes an ``n``-point cloud on the card: 'fps'
    (``csrc/fps.cu``, one block a cloud) up to ``FPS_MAX_N`` points,
    'fps_chunked' (``csrc/fps_chunked.cu``, one cluster a cloud) beyond."""
    return "fps" if n <= _fps.FPS_MAX_N else "fps_chunked"


def farthest_point_sample(npoint: int, xyz: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """(b, n, 3) → (b, npoint) int32 indices; the first is always 0.

    impl: 'auto' (on a CUDA tensor the kernel :func:`fps_kernel_for` names,
    on a CPU tensor the plain version), 'cuda' (the kernel, or raise),
    'torch' (the plain version), or 'batch', the JAX package's name for its
    streaming merge, which routes as 'auto': every cloud of the batch
    already gets its own block or cluster.  All give the bits of the JAX
    package's ``_fps_xla``, ``fps_pallas`` and ``fps_pallas_chunked``:
    seed 0, min-distances from 1e38, first-occurrence argmax.
    """
    if impl == "batch":
        impl = "auto"
    xyz = xyz.to(torch.float32).contiguous()
    if fps_kernel_for(xyz.shape[1]) == "fps":
        return _fps.fps(npoint, xyz, impl=impl)
    return _fps_chunked.fps_chunked(npoint, xyz, impl=impl)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``points`` at (b, m) indices → (b, m, c).  Its
    gradient is the scatter-add of ``torch.gather``'s backward."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, idx)


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` drawn from ``generator``
    (u uniform in (0, 1), kept off 0 by the smallest normal f32)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def nonuniform_indices_from(loc_u: torch.Tensor, noise: torch.Tensor,
                            sample_num: int) -> torch.Tensor:
    """Gaussian-biased draw of ``sample_num`` distinct indices in [0, num)
    for each row, given its draws: ``loc_u`` (b,) uniform in [0, 1) and
    ``noise`` (b, num) standard Gumbel.

    Gumbel-top-k over the log-density of N(loc·num, 0.3·num) with
    loc = 0.1 + 0.8·u, as the JAX package's ``nonuniform_sample_indices``
    computes it; the top k is a stable descending sort, so equal keys go
    to the lower index as in ``lax.top_k``.  Returns (b, sample_num) int32.
    """
    num = noise.shape[-1]
    loc = loc_u[:, None] * 0.8 + 0.1
    positions = (torch.arange(num, dtype=torch.float32, device=noise.device)
                 + 0.5) / num
    log_density = -((positions - loc) ** 2) / (2.0 * 0.3 ** 2)
    order = torch.sort(log_density + noise, dim=-1, descending=True,
                       stable=True).indices
    return order[:, :sample_num].to(torch.int32)


def nonuniform_sample_indices(b: int, num: int, sample_num: int,
                              generator: torch.Generator,
                              device=None) -> torch.Tensor:
    """(b, sample_num) int32 distinct indices in [0, num), each row a
    Gaussian-biased draw from ``generator`` (see
    :func:`nonuniform_indices_from`)."""
    loc_u = torch.rand((b,), generator=generator, device=device)
    return nonuniform_indices_from(
        loc_u, gumbel((b, num), generator, device), sample_num)
