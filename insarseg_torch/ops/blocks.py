"""Blocks of the port (counterparts in ``insarseg/ops/blocks.py``), NCHW.

- :class:`DoubleConv` and :class:`SELayer` (U-Net): the Sequential indices
  reproduce the reference state_dict names ``double_conv.{0,1,3,4,6}``
  (conv, BN, ReLU, conv, BN, ReLU, SE) and ``fc.{0,2}`` (Linear, ReLU,
  Linear; no bias, reduction 16); in train mode each conv -> BN -> ReLU
  runs as the conv without its bias (:class:`BNFedConv2d`) and the fused
  epilogue ``ops/layers.py::bn_train`` (the bias added there,
  with no gradient; the JAX package's moments), and with ``remat`` the
  block's activations are recomputed in the backward pass
  (``torch.utils.checkpoint``, the JAX package's ``nn.remat``);
- :class:`SEBlock` (FCN-CA bottlenecks): the same squeeze-excite with a
  bias-free 1x1-conv MLP, ``fc.{0,2}``;
- :class:`ChannelAttentionModule` (DeepLab-CA, CBAM channel): avg- and
  max-pooled descriptors through one shared 1x1-conv MLP ``mlp.{0,2}``,
  summed, sigmoid;
- :class:`SpatialAttentionDC` (U-Net-SA): channel mean and max ->
  ``compress_and_map`` = DoubleConv(2 -> 1) -> sigmoid -> per-pixel rescale;
- :class:`SpatialAttentionConv` (DeepLab-SA / FCN-SA, CBAM spatial):
  channel mean and max -> ``conv`` (2 -> 1, k x k, no bias) -> sigmoid.

Convs and linears are ``ops/layers.py``'s, in their input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from insarseg_torch.ops.layers import (
    Conv2d,
    Linear,
    bn_train,
    follow,
    global_avg_pool,
    global_max_pool,
    spatial_mean,
)
from insarseg_torch.parallel import spatial


class SELayer(nn.Module):
    """GAP -> Linear(C, C/r) -> ReLU -> Linear(C/r, C) -> sigmoid ->
    channelwise rescale; the GAP over every slab under a spatial context
    (``ops/layers.py::spatial_mean``)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channels, channels // reduction, bias=False),
            nn.ReLU(inplace=True),
            Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(spatial_mean(x))
        return x * y[:, :, None, None]


class BNFedConv2d(Conv2d):
    """A conv whose output feeds a BatchNorm directly (the JAX package's
    ``Conv2d(stop_bias_grad=train)``, ``insarseg/ops/layers.py:80-89``). In
    train mode BN subtracts the batch mean, so a per-channel shift cancels
    and the bias's gradient is exactly zero; autograd would give float
    noise (~1e-8) instead, on which Adam takes full-size steps. So a
    train-mode :class:`DoubleConv` calls it with ``with_bias=False`` and
    adds the bias, detached, in its fused BatchNorm epilogue: the bias
    gets no gradient and keeps its value. The state_dict names are
    ``nn.Conv2d``'s."""

    def forward(self, x: torch.Tensor,
                with_bias: bool = True) -> torch.Tensor:
        return self._conv_forward(x, follow(x, self.weight),
                                  follow(x, self.bias) if with_bias else None)


class DoubleConv(nn.Module):
    """(Conv3x3 same-pad -> BN -> ReLU) x2, optional SE tail.

    In train mode each conv runs without its bias and its BN -> ReLU is
    ``bn_train`` (kernels K8a / K8b forward, K9a / K9b backward on
    the card; the bias added there with no gradient, the JAX package's
    moment rule, the running statistics and ``num_batches_tracked``
    updated; over the ranks when the BN is ``synced``). Eval mode runs the
    Sequential as it is.

    With ``remat`` a train-mode forward under autograd runs in
    ``torch.utils.checkpoint`` (``use_reentrant=False``): its activations
    are not kept and the block runs again in the backward pass. The
    second run uses the same batch statistics and computes the same
    values; its BN running statistics and ``num_batches_tracked`` are put
    back as the first run left them (the JAX recompute updates no
    state). The recompute runs under the spatial context of the first
    run (``parallel/spatial.py``), so a slab exchanges the same halo rows
    and sums again, in the same order on every rank. Eval mode never
    checkpoints.

    Under a spatial context the 3x3 convs take their halo rows from the
    neighbouring slabs (``ops/layers.py::Conv2d``), the synced BatchNorm
    sums each slab's moments over every rank, and the SE squeeze sums over
    the slabs (``SELayer``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_se: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        layers = [
            BNFedConv2d(in_channels, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
            BNFedConv2d(out_channels, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        ]
        if use_se:
            layers.append(SELayer(out_channels))
        self.double_conv = nn.Sequential(*layers)

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.double_conv
        for conv, bn in ((seq[0], seq[1]), (seq[3], seq[4])):
            x = bn_train(conv(x, with_bias=False), bn, "relu",
                         bias=conv.bias)
        return seq[6](x) if len(seq) > 6 else x

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        return self._train(x) if self.training else self.double_conv(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._run(x)
        first = [True]
        comm = spatial.current()

        def run(t: torch.Tensor) -> torch.Tensor:
            if first[0]:
                first[0] = False
                return self._run(t)
            # the recompute may stop early (it raises once the tensors the
            # backward needs are back), so the statistics go back in any case
            kept = {k: v.clone() for k, v in self.named_buffers()}
            try:
                with spatial.active(comm):
                    return self._run(t)
            finally:
                with torch.no_grad():
                    for k, v in self.named_buffers():
                        v.copy_(kept[k])

        return checkpoint(run, x, use_reentrant=False)


class SEBlock(nn.Module):
    """GAP -> 1x1 conv (C -> C/r) -> ReLU -> 1x1 conv (C/r -> C) ->
    sigmoid -> channelwise rescale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            Conv2d(channels, channels // reduction, 1, bias=False),
            nn.ReLU(inplace=True),
            Conv2d(channels // reduction, channels, 1, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(global_avg_pool(x))


class ChannelAttentionModule(nn.Module):
    """sigmoid(MLP(avgpool(x)) + MLP(maxpool(x))) * x, one shared MLP."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(
            Conv2d(channels, channels // reduction, 1, bias=False),
            nn.ReLU(inplace=True),
            Conv2d(channels // reduction, channels, 1, bias=False),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = self.mlp(global_avg_pool(x)) + self.mlp(global_max_pool(x))
        return x * torch.sigmoid(att)


def _mean_max(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 2, H, W): the channel mean and max."""
    return torch.cat([x.mean(dim=1, keepdim=True),
                      x.amax(dim=1, keepdim=True)], dim=1)


class SpatialAttentionDC(nn.Module):
    """x * sigmoid(DoubleConv(2 -> 1)([mean_c(x), max_c(x)]))."""

    def __init__(self):
        super().__init__()
        self.compress_and_map = DoubleConv(2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.compress_and_map(_mean_max(x)))


class SpatialAttentionConv(nn.Module):
    """x * sigmoid(conv([mean_c(x), max_c(x)])), kernel 3 or 7."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        if kernel_size not in (3, 7):
            raise ValueError("kernel size must be 3 or 7")
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                           bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(_mean_max(x)))
