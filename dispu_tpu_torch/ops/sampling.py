"""Farthest-point sampling (exact, and bucketed by Morton order, ranked
by a stable argsort or by the sort-free counting rank), row gathers, the
training input's nonuniform draw and the inverse-CDF draw (counterpart of
``ops/sampling.py``)."""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels import fps as _fps
from dispu_tpu_torch.kernels import fps_bucketed as _fps_bucketed
from dispu_tpu_torch.kernels import fps_chunked as _fps_chunked
from dispu_tpu_torch.parallel.mesh import (all_gather_rows, data_size,
                                           local_rows)


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


def _morton_spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit (int64
    carries the JAX package's uint32 arithmetic)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(xyz: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(..., n, 3) points → (..., n) int32 interleaved-bit (Z-order) keys,
    each cloud quantized over its own bounding box.  The f32 quantization
    is the JAX package's, operation for operation: ``(xyz − lo) · ((2^bits
    − 1) / max(hi − lo, 1e-12))``, truncated toward zero, clipped."""
    lo = torch.amin(xyz, dim=-2, keepdim=True)
    hi = torch.amax(xyz, dim=-2, keepdim=True)
    # a tensor numerator: ``scalar / tensor`` is a reciprocal then a
    # product in PyTorch, which rounds differently from the division
    scale = torch.full_like(hi, 2 ** bits - 1) / torch.clamp_min(hi - lo,
                                                                1e-12)
    q = torch.clamp(((xyz - lo) * scale).to(torch.int32), 0, 2 ** bits - 1)
    q = q.to(torch.int64)
    code = (_morton_spread3(q[..., 0]) | (_morton_spread3(q[..., 1]) << 1)
            | (_morton_spread3(q[..., 2]) << 2))
    return code.to(torch.int32)


#: the counting rank's chunk: its within-chunk compare is (n, chunk)
#: booleans, its per-chunk histograms (n / chunk, n_bins) int32s
RANK_CHUNK = 256


def morton_rank(codes: torch.Tensor, n_bins: int,
                chunk: int = RANK_CHUNK) -> torch.Tensor:
    """Stable counting rank of small-alphabet int keys, without a sort (the
    JAX package's ``morton_rank``): (..., n) keys in [0, n_bins) → (...,
    n) int32 ``pos``, element i's place in the stable ascending sort of
    its row (the inverse of a stable argsort; equal keys keep their index
    order).

    Each row is cut into chunks of ``chunk`` keys (the last one padded
    with keys that rank after every real one).  A key's place is the
    count of smaller keys in its row (the exclusive sum of the row's
    histogram), plus the count of equal keys in earlier chunks (an
    exclusive sum over the chunks' histograms), plus the count of equal
    keys before it in its own chunk (a strictly lower-triangular compare).
    Every count is exact in int32, so any ``chunk`` gives the same bits;
    the JAX package carries the chunks' histogram through a ``lax.scan``,
    here all chunks are counted at once."""
    *lead, n = codes.shape
    codes = codes.reshape(-1, n).to(torch.int64)
    rows, dev = codes.shape[0], codes.device
    n_ch = max(1, -(-n // chunk))
    pad = n_ch * chunk - n
    if pad:  # after every real key: real places do not move
        codes = torch.cat([codes, codes.new_full((rows, pad), n_bins - 1)],
                          dim=1)
    ch = codes.reshape(rows, n_ch, chunk)
    hist = torch.zeros((rows * n_ch * n_bins,), dtype=torch.int32,
                       device=dev)
    base = (torch.arange(rows * n_ch, device=dev) * n_bins).reshape(
        rows, n_ch, 1)
    hist.scatter_add_(0, (ch + base).reshape(-1),
                      torch.ones((rows * n_ch * chunk,), dtype=torch.int32,
                                 device=dev))
    hist = hist.reshape(rows, n_ch, n_bins)
    before = torch.cumsum(hist, dim=1) - hist          # earlier chunks
    total = torch.sum(hist, dim=1)                     # (rows, n_bins)
    start = torch.cumsum(total, dim=1) - total         # smaller keys
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev), diagonal=-1)
    within = torch.sum((ch[..., :, None] == ch[..., None, :]) & tri,
                       dim=-1, dtype=torch.int32)
    pos = (torch.gather(start, 1, codes)
           + torch.gather(before, 2, ch).reshape(rows, -1)
           + within.reshape(rows, -1))
    return pos[:, :n].to(torch.int32).reshape(*lead, n)


def farthest_point_sample_bucketed(npoint: int, xyz: torch.Tensor,
                                   n_buckets: int = 64, impl: str = "auto",
                                   rank_impl: str = "argsort",
                                   mesh=None, bits: int = 10) -> torch.Tensor:
    """Approximate FPS of B clouds by spatial buckets: (B, n, 3) → (B,
    npoint) int32 indices (the JAX package's function of one cloud, for
    each cloud of the batch).

    Each cloud is ranked by its ``bits``-bit Morton codes, padded with its
    last-ranked point to ``n_buckets`` equal buckets of n_b = max(ceil(n /
    K), m_b) points, m_b = ceil(npoint / K); every bucket of every cloud
    runs exact FPS for m_b points in one ``fps_bucketed`` call (the kernel
    on a CUDA tensor); the picks come back round-robin by bucket, cut to
    ``npoint``.  ``rank_impl`` 'argsort': a stable argsort of the codes,
    as ``jnp.argsort``; 'radix': :func:`morton_rank` over the 2^(3·bits)
    codes and one permutation scatter, which needs ``bits`` ≤ 4.  Both
    ranks are stable, so at equal ``bits`` they give the same buckets bit
    for bit (the serving merge takes 'radix' at 4 bits, as the JAX
    package's does).

    ``mesh``: each process selects in its ``n_buckets`` / W buckets of
    every cloud and the picks are all-gathered; the buckets are
    independent, so the result is the single-device selection bit for bit.
    ``n_buckets`` must be divisible by the data axis."""
    if mesh is not None and n_buckets % data_size(mesh):
        raise ValueError(
            f"n_buckets={n_buckets} must be divisible by the data axis "
            f"({data_size(mesh)} devices)")
    if rank_impl not in ("argsort", "radix"):
        raise ValueError(f"unknown rank_impl {rank_impl!r}")
    if rank_impl == "radix" and bits > 4:
        raise ValueError(
            f"rank_impl='radix' needs bits <= 4 (2^(3*bits) histogram "
            f"bins), got bits={bits}")
    b, n, _ = xyz.shape
    k = n_buckets
    m_b = -(-npoint // k)
    n_b = max(-(-n // k), m_b)
    xyz = xyz.to(torch.float32)
    codes = morton_codes(xyz, bits=bits)
    if rank_impl == "radix":
        pos = morton_rank(codes, n_bins=1 << (3 * bits)).long()
        order = torch.empty_like(pos).scatter_(
            1, pos, torch.arange(n, device=xyz.device).expand(b, n))
    else:
        order = torch.argsort(codes, dim=-1, stable=True)
    pad = k * n_b - n
    if pad:
        order = torch.cat([order, order[:, -1:].expand(b, pad)], dim=1)
    buckets = gather_point(xyz, order).reshape(b * k, n_b, 3)
    if mesh is None:
        local = _fps_bucketed.fps_bucketed(m_b, buckets.contiguous(),
                                           impl=impl)
    else:
        w = data_size(mesh)
        mine = buckets.reshape(b, k, n_b, 3)[:, local_rows(mesh, k)]
        picks = _fps_bucketed.fps_bucketed(
            m_b, mine.reshape(b * k // w, n_b, 3).contiguous(), impl=impl)
        # (W, b, K/W, m_b) → each cloud's buckets in rank order
        every = all_gather_rows(picks.reshape(b, k // w, m_b), mesh)
        local = every.transpose(0, 1).reshape(b * k, m_b)
    picked = torch.gather(order.reshape(b * k, n_b), 1, local.long())
    # round-robin: every bucket's j-th pick before any (j+1)-th
    picked = picked.reshape(b, k, m_b).transpose(1, 2).reshape(b, k * m_b)
    return picked[:, :npoint].to(torch.int32)


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


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last axis in the order XLA's CPU backend
    adds, so that the f32 bits are ``jnp.cumsum``'s there: rows of 16
    (the last one padded with zeros) summed left to right, the rows'
    totals summed so recursively, and each row's exclusive prefix of
    totals added last.  Each add is one f32 add, on any device."""
    n = x.shape[-1]
    if n <= 16:
        acc, out = x[..., 0], [x[..., 0]]
        for j in range(1, n):
            acc = acc + x[..., j]
            out.append(acc)
        return torch.stack(out, dim=-1)
    r = -(-n // 16)
    rows = torch.nn.functional.pad(x, (0, 16 * r - n)).reshape(
        *x.shape[:-1], r, 16)
    within = xla_cumsum(rows)
    tot = xla_cumsum(within[..., -1])
    prefix = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]],
                       dim=-1)
    return (within + prefix[..., None]).reshape(*x.shape[:-1], 16 * r)[..., :n]


def prob_sample(inp: torch.Tensor, inp_r: torch.Tensor) -> torch.Tensor:
    """Categorical draw by inverse-CDF lookup (the JAX package's
    ``prob_sample``; the model does not use it): (b, n) non-negative
    weights and (b, m) uniform draws in [0, 1) → (b, m) int32 indices
    distributed ∝ ``inp``.  The CDF is :func:`xla_cumsum`, the targets
    ``inp_r · total``, each index the first CDF entry above its target,
    clipped to n − 1: the JAX package's indices on the same draws."""
    cdf = xla_cumsum(inp.to(torch.float32))
    targets = inp_r.to(torch.float32) * cdf[..., -1:]
    idx = torch.searchsorted(cdf.contiguous(), targets.contiguous(),
                             right=True)
    return torch.clamp(idx, 0, inp.shape[-1] - 1).to(torch.int32)
