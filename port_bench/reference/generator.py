"""The Dis-PU generator in plain PyTorch, as published (liruihui/Dis-PU,
``DisPU/generator.py``, CVPR 2021) at ``GeneratorConfig()``'s settings:
a dense-GCN feature extractor, feature duplication with a 2-D grid code, a
coarse coordinate regressor, then the spatial refiner (local pooling with
learned weights, a skip branch, a global non-local attention branch) and
a bounded offset regressor.

Weights are a flat dict of tensors under the benchmarked program's state
dict names (``configs/dispu.json``'s ``weights`` lists them), so the
harness hands the same tensors to both.  Dense layers are ``x·Wᵀ + b``
with W stored (out, in).  Departures, each one the program's stated
numerics: the global attention takes bf16 operands where the map is at
least 512² (``attention_bf16``; the program's attention contract on the
card), and every f32 product runs in full f32 unless the caller lets
TF32 in (the precision control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import ops
from port_bench.reference.flops import counted_as_bf16

BN_EPS = 1e-3


def dense(P, name, x, act=True):
    y = F.linear(x, P[name + ".dense.weight"], P[name + ".dense.bias"])
    return torch.relu(y) if act else y


def batch_norm(P, name, x, training):
    """Flax's convention: batch moments ``E[x]``, ``max(E[x²] − E[x]², 0)``
    in training, the running ones otherwise."""
    if training:
        axes = tuple(range(x.dim() - 1))
        mean = torch.mean(x, dim=axes)
        var = torch.maximum(torch.mean(x * x, dim=axes) - mean * mean,
                            x.new_zeros(()))
    else:
        mean, var = P[name + ".mean"], P[name + ".var"]
    mul = torch.rsqrt(var + BN_EPS) * P[name + ".scale"]
    return (x - mean) * mul + P[name + ".bias"]


def dense_block(P, name, feature, k):
    """EdgeConv dense block (dense_n 3, max over the k neighbours): the
    feature-space kNN with k + 1 neighbours, repeated rows last, self
    dropped; [centre, neighbour − centre] through three convs, each output
    concatenated before its input."""
    idx = ops.knn(k + 1, feature, feature, unique=True)[:, :, 1:]
    nbr = ops.group(feature, idx)
    center = feature[:, :, None, :].expand_as(nbr)
    y = torch.cat([center, nbr - center], dim=-1)
    y = torch.cat([dense(P, name + ".l0", y), center], dim=-1)
    y = torch.cat([dense(P, name + ".l1", y), y], dim=-1)
    y = torch.cat([dense(P, name + ".l2", y, act=False), y], dim=-1)
    return torch.amax(y, dim=-2)


def feature_extractor(P, xyz, k=16, blocks=4):
    name = "feature_extraction_coarse"
    feat = dense(P, name + ".layer0", xyz, act=False)
    out = torch.cat([dense_block(P, name + ".layer1", feat, k), feat], dim=-1)
    for b in range(2, blocks + 1):
        prep = dense(P, f"{name}.layer{b}_prep", out)
        out = torch.cat([dense_block(P, f"{name}.layer{b}", prep, k), out],
                        dim=-1)
    return out


def grid_code(up_ratio, like):
    """(r, 2) codes in [−0.2, 0.2]², the most square factorization of r,
    'xy' order."""
    nx = 1
    for i in reversed(range(1, int(math.sqrt(up_ratio)) + 2)):
        if up_ratio % i == 0:
            nx = i
            break
    ny = up_ratio // nx
    gx = torch.linspace(-0.2, 0.2, nx, dtype=torch.float32)
    gy = torch.linspace(-0.2, 0.2, ny, dtype=torch.float32)
    x, y = torch.meshgrid(gx, gy, indexing="xy")
    return torch.stack([x, y], dim=-1).reshape(-1, 2).to(like)


def duplicate_up(P, feat, r):
    b, n, _ = feat.shape
    grid = torch.repeat_interleave(grid_code(r, feat), n, dim=0)
    net = torch.cat([feat.repeat(1, r, 1), grid[None].expand(b, -1, -1)],
                    dim=-1)
    return dense(P, "upshuffle_0.conv2", dense(P, "upshuffle_0.conv1", net))


def regressor(P, name, feat, offset_range=None):
    x = dense(P, name + ".fc_layer1", dense(P, name + ".fc_layer0", feat))
    x = dense(P, name + ".fc_layer2", x, act=False)
    if offset_range is not None:
        x = torch.sigmoid(x) * (2.0 * offset_range) - offset_range
    return x


def attention(q, k, v, scale, bf16):
    """``softmax(scale·q·kᵀ)·v``; with ``bf16`` q, k, v and the
    probabilities rounded to bf16 for the two products (exact products,
    f32 sums, counted at the bf16 peak), the denominator summed over the
    unrounded f32 probabilities."""
    if not bf16:
        return torch.matmul(torch.softmax(
            torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1), v)

    def r(t):
        return t.to(torch.bfloat16).to(torch.float32)

    with counted_as_bf16():
        s = torch.matmul(r(q), r(k).transpose(-1, -2)) * scale
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    denom = torch.sum(p, dim=-1, keepdim=True)
    with counted_as_bf16():
        return torch.matmul(r(p), r(v)) / denom


def refiner(P, xyz, feat, training, attention_bf16, k=16):
    """PointShuffle2: kNN grouping of [xyz | feature] (k 16) → local
    branch (two convs, pooling weights from a batch-normed conv over the
    centred xyz, the k-major flatten through ``after_conv``) + skip branch
    (max, conv) + non-local branch (global attention) → aggregation."""
    name = "PointShuffle"
    b, n, c = feat.shape
    idx = ops.knn(k, xyz, xyz)
    grouped = ops.group(torch.cat([xyz, feat], dim=-1), idx)
    centred = grouped[..., :3] - xyz[:, :, None, :]
    grouped = torch.cat([centred, grouped], dim=-1)         # 6 + c

    kv = dense(P, name + ".non_local.conv_kv", feat, act=False)
    q = dense(P, name + ".non_local.conv_query", feat, act=False)
    bc = q.shape[-1]
    big = (attention_bf16 and n * n >= 512 * 512 and n <= 8192
           and bc <= 256)
    nl = attention(q, kv[..., :bc], kv[..., bc:], 1.0 / float(bc) ** 0.5,
                   big)
    nl = dense(P, name + ".non_local.conv_back_project", nl)

    skip = dense(P, name + ".skip", torch.amax(grouped, dim=2))
    y = dense(P, name + ".conv1", dense(P, name + ".conv0", grouped))
    wn = name + ".weight_net.wconv0"
    w = F.linear(centred, P[wn + ".dense.weight"], P[wn + ".dense.bias"])
    w = torch.relu(batch_norm(P, wn + ".bn", w, training))  # (b, n, k, k)
    y = torch.einsum("bnkt,bnkc->bntc", w, y).reshape(b, n, -1)
    wa = P[name + ".after_conv.dense.weight"]                # (out, c·k)
    f = wa.shape[0]
    wa = wa.reshape(f, y.shape[-1] // k, k).transpose(1, 2).reshape(f, -1)
    y = torch.relu(F.linear(y, wa, P[name + ".after_conv.dense.bias"]))
    return dense(P, name + ".aggregation", y + skip + nl)


def generator(P, patches, training=False, attention_bf16=False):
    """(b, n, 3) patches → (coarse, fine), each (b, 4n, 3)."""
    feat = duplicate_up(P, feature_extractor(P, patches), 4)
    coarse = regressor(P, "coarse_coordinate_regressor", feat)
    fine_feat = refiner(P, coarse, feat, training, attention_bf16)
    offset = regressor(P, "fine_coordinate_regressor", fine_feat,
                       offset_range=0.5)
    return coarse, coarse + offset
