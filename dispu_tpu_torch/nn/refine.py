"""The spatial refiner core, ``PointShuffle2`` (counterpart of
``nn/refine.py``).

  1. kNN-group xyz + features (k = ``nsample``; on the card the kNN
     kernel and one combined ``[xyz | feature]`` gather, or with
     ``gather_impl`` 'fused' / 'fused_turbo' the ``knn_group`` kernel;
     see ``ops.grouping.grouping``), or with ``use_knn=False`` ball-group
     them (the ball-query kernel, radius 0.2 unless ``radius`` is given);
     with ``refine_point``, re-position each point and its query feature
     from its neighbourhood (``SampleWeights`` + ``adaptive_sampling``);
  2. local branch: per-edge MLP → pooling weights from ``WeightNetHidden``
     over the centred xyz → ``bnkt,bnkc->bntc`` pooling → k-major flatten
     → ``after_conv``, whose stored kernel rows stay (C', k)-major and are
     permuted at apply time;
  3. skip branch: max over the neighbours → dense;
  4. non-local branch: global attention over the whole cloud (the
     attention kernel on the card);
  5. the branches summed, then ``aggregation``.

At inference, ``local_impl`` 'fused' runs steps 2 and 3 on the grouped
tensor in one kernel (``kernels/refine_local.py``), and 'megafused' steps
1 to 3 with no grouped tensor (``kernels/refine_block.py``: on the card
the exact kNN's kernel, then one kernel for the rest), inside the JAX
package's gates; elsewhere, training included, the composed
path runs.  'megafused''s kernel takes any n; on the card, at widths
whose tile does not fit its shared memory, 'megafused' computes the same
function by the 'fused' route (n % 128 == 0) or the composed one: the
exact kNN, the features rounded to bf16 in the grouping, then the local
branch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dispu_tpu_torch.config import REFINE_LOCAL_IMPLS
from dispu_tpu_torch.kernels.refine_block import block_fits, refine_block
from dispu_tpu_torch.kernels.refine_local import LocalParams, refine_local
from dispu_tpu_torch.nn.attention import (PointNonLocalCell, SampleWeights,
                                          adaptive_sampling)
from dispu_tpu_torch.nn.layers import PointConv, WeightNetHidden
from dispu_tpu_torch.ops.grouping import grouping
from dispu_tpu_torch.utils.checkpoint import current_key


def _rename_old_keys(module, state_dict, prefix, *args) -> None:
    """Load-state-dict pre-hook: this module's keys of an older state dict
    under their current names (:func:`current_key`)."""
    for key in [k for k in state_dict if k.startswith(prefix)]:
        new = prefix + current_key(key[len(prefix):])
        if new != key:
            state_dict[new] = state_dict.pop(key)


class PointShuffle2(nn.Module):
    """Local + non-local refinement: xyz (b, n, 3), feature (b, n, c) →
    (xyz, (b, n, mlp[-1])).

    local_impl: the local and skip branches' evaluation, as
    ``GeneratorConfig.refine_local_impl``: 'xla' (the composed path),
    'fused' or 'megafused'.  Both kernels take the same parameters, folded
    from the module's own at each call (:meth:`local_params`); the stored
    layout stays the composed path's.

    refine_point: the returned xyz are the points re-positioned by
    ``noise_refine`` (``SampleWeights([c, c])``), whose query features,
    6 + c wide, feed the non-local cell.  The JAX package runs it at c = 2
    alone: its c weight channels, less the xyz's, must broadcast against
    the 6 + c grouped channels; any other width raises here, as it fails
    there.
    """

    def __init__(self, in_features: int, nsample: int = 16,
                 mlp: Tuple[int, ...] = (128, 128, 256), use_bn: bool = False,
                 bn_momentum: float = 0.95, use_knn: bool = True,
                 radius: Optional[float] = None, use_nonlocal: bool = True,
                 use_local: bool = True, refine_point: bool = False,
                 gather_impl: str = "gather", impl: str = "auto",
                 knn_variant: str = "auto", local_impl: str = "xla"):
        super().__init__()
        if local_impl not in REFINE_LOCAL_IMPLS:
            raise ValueError(f"local_impl must be one of {REFINE_LOCAL_IMPLS}"
                             f", got {local_impl!r}")
        c, k, out_c = in_features, nsample, mlp[-1]
        grouped = 6 + c  # [centred xyz | raw xyz | feature]
        if refine_point and c != 2:
            raise ValueError(
                f"refine_point needs in_features 2: its {c} - 1 = {c - 1} "
                f"feature weight channels multiply the {grouped} grouped "
                f"channels, as the JAX package's adaptive_sampling does")
        self.mlp = tuple(mlp)
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.nsample, self.gather_impl, self.impl = k, gather_impl, impl
        self.knn_variant, self.local_impl, self.use_bn = (knn_variant,
                                                          local_impl, use_bn)
        self.use_knn, self.refine_point = use_knn, refine_point
        self.radius = 0.2 if radius is None else radius
        self.use_nonlocal, self.use_local = use_nonlocal, use_local
        if refine_point:
            self.noise_refine = SampleWeights(grouped, (c, c), **kw)
        if use_nonlocal:
            # flax's 'nonlocal' is a Python keyword, which the code of an
            # exported program cannot hold as an attribute; a state dict
            # under the old name still loads
            self.non_local = PointNonLocalCell(
                c, grouped if refine_point else c,
                bottleneck=max(32, c // 2), out_features=out_c, impl=impl,
                **kw)
            self.register_load_state_dict_pre_hook(_rename_old_keys)
        self.skip = PointConv(grouped, out_c, **kw)
        width = grouped
        for i, ch in enumerate(mlp[:-1]):
            self.add_module(f"conv{i}", PointConv(width, ch, **kw))
            width = ch
        self.num_convs = len(mlp) - 1
        self.weight_net = WeightNetHidden(3, (k,), bn_momentum=bn_momentum)
        # width entering the pooling: the last hidden conv's, or the raw
        # grouped width when mlp[:-1] is empty
        self.after_conv = PointConv(width * k, out_c,
                                    kernel_row_perm=(width, k), **kw)
        self.aggregation = PointConv(out_c, out_c, **kw)

    def local_route(self, feature: torch.Tensor) -> str:
        """Which path the local and skip branches take for ``feature``:
        the JAX package's gates (``dispu_tpu/nn/refine.py``).  'fused' and
        'megafused' need inference (``.eval()``), no batch norm, two hidden
        convs and f32; 'megafused' also the local branch, k ≤ 16, the kNN
        grouping and no ``refine_point``, 'fused' n % 128 == 0.
        Otherwise 'xla', the composed path.  Where 'megafused' would
        launch ``refine_block.cu`` at widths past its shared memory
        (:func:`~dispu_tpu_torch.kernels.refine_block.block_fits`; any n
        fits), 'fused' where n % 128 == 0, else 'xla'."""
        return self._routes(feature)[0]

    def _routes(self, feature: torch.Tensor):
        """(:meth:`local_route`, the grouping's (gather_impl,
        knn_variant)).  'megafused' past its kernel's widths groups as
        ``refine_block`` does: the exact kNN, xyz exact, the features
        rounded to bf16 ('onehot', or 'fused_turbo' with the fused
        grouping kernel)."""
        n, c = feature.shape[1:]
        grouping_impls = (self.gather_impl, self.knn_variant)
        fusable = (not self.training and not self.use_bn
                   and self.num_convs == 2
                   and feature.dtype == torch.float32)
        if (self.local_impl == "megafused" and fusable and self.use_local
                and self.use_knn and not self.refine_point
                and self.nsample <= 16):
            on_card = feature.is_cuda and self.impl != "torch"
            if not on_card or block_fits(self.nsample, 6 + c, *self.mlp):
                return "megafused", grouping_impls
            bf16 = ("fused_turbo" if self.gather_impl.startswith("fused")
                    else "onehot")
            return "fused" if n % 128 == 0 else "xla", (bf16, "auto")
        if self.local_impl == "fused" and fusable and n % 128 == 0:
            return "fused", grouping_impls
        return "xla", grouping_impls

    def local_params(self) -> LocalParams:
        """The local and skip branches' parameters as the kernels take
        them, from the module's own at call time: dense kernels as (in,
        out); the weight net's inference batch norm folded into its dense
        layer (``sc = scale · rsqrt(var + eps)``); ``after_conv``'s kernel
        as (k, c', c_out) t-major blocks of the weight its apply uses."""
        conv0, conv1 = self.conv0.dense, self.conv1.dense
        wconv = self.weight_net.wconv0
        bn = wconv.bn
        sc = bn.scale * torch.rsqrt(bn.var + bn.epsilon)
        after = self.after_conv.dense
        waf = after.effective_weight().t().reshape(
            self.nsample, conv1.weight.shape[0], -1)
        return LocalParams(
            conv0.weight.t(), conv0.bias, conv1.weight.t(), conv1.bias,
            wconv.dense.weight.t() * sc, (wconv.dense.bias - bn.mean) * sc
            + bn.bias, self.skip.dense.weight.t(), self.skip.dense.bias, waf,
            after.bias)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor):
        b, n, _ = feature.shape
        route, (gather_impl, knn_variant) = self._routes(feature)
        if route != "megafused":
            grouped_xyz, grouped_feat, _ = grouping(
                feature, self.nsample, xyz, xyz, use_xyz=True,
                use_knn=self.use_knn, radius=self.radius,
                gather_impl=gather_impl, impl=self.impl,
                knn_variant=knn_variant,
            )
            centered = grouped_xyz - xyz[:, :, None, :]
            grouped_feat = torch.cat([centered, grouped_feat], dim=-1)

        new_xyz, new_feat = xyz, feature
        if self.refine_point:
            new_xyz, new_feat = adaptive_sampling(
                self.noise_refine, centered, grouped_feat, self.nsample)
        if self.use_nonlocal:
            nl = self.non_local(feature, new_feat[:, None])[:, 0]
        if self.use_nonlocal and not self.use_local:
            y = nl
        else:
            if route == "megafused":
                y = refine_block(xyz, feature, self.local_params(),
                                 impl=self.impl)
            elif route == "fused":
                y = refine_local(grouped_feat, self.local_params(),
                                 impl=self.impl)
            else:
                skip = self.skip(torch.amax(grouped_feat, dim=2))
                y = grouped_feat
                for i in range(self.num_convs):
                    y = getattr(self, f"conv{i}")(y)
                w = self.weight_net(centered)              # (b, n, k, k)
                y = torch.einsum("bnkt,bnkc->bntc", w, y)
                y = self.after_conv(y.reshape(b, n, -1))   # k-major flatten
                y = y + skip
            if self.use_nonlocal:
                y = y + nl
        return new_xyz, self.aggregation(y)
