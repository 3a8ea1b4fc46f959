"""Image towers for scene -> product retrieval, Shop the Look
(counterpart of ``esrecsys_tpu/models/cnn.py``).

Per stage a stride-2 3x3 conv (and a stride-2 3x3 residual conv), three
BatchNorm + swish sub-blocks with 1x1 convs, then a stride-2 3x3 average
pool: a 4x spatial downsample a stage; then the spatial mean and a Dense
projection. Two towers (scene, product) scored by dot product.

Names and semantics follow the reference's flax modules, so parameters,
BatchNorm statistics and artifacts cross (``convert.stl_params_from_jax``):
  * module paths ``scene_tower.ResidualStage_0.Conv_0`` ... ``Conv_3``,
    ``BatchNorm_0`` ... ``BatchNorm_2``, ``Dense_0``; the residual conv is
    created first, so it is ``Conv_0``. Kernels are stored in PyTorch's
    layouts: a conv ``(out, in, kh, kw)`` (flax: ``(kh, kw, in, out)``), a
    Dense ``(out, in)`` (flax: ``(in, out)``).
  * flax's ``SAME`` padding: ``pad_total = max((ceil(n/s) - 1) s + k - n,
    0)``, ``pad_total // 2`` before; at an even size that is (0, 1), which
    a symmetric ``padding=`` cannot express, so the stage pads once with
    ``F.pad`` and its convs and pool run unpadded. The average pool counts
    the padded zeros (divides by 9), as ``nn.avg_pool`` does.
  * flax's BatchNorm, not ``nn.BatchNorm2d``: statistics in float32 (or
    wider) over
    (N, H, W), ``var = max(0, E[x²] - E[x]²)`` (biased), running update
    ``0.99 ra + 0.01 batch`` on the biased var, eps 1e-5, a ``scale`` and
    no bias, normalised in float32 and cast to the compute dtype. The
    running statistics are buffers ``mean`` and ``var``.
  * bf16 rounding follows XLA's: a conv rounds its output to the compute
    dtype before the bias (also in it) is added; the spatial mean is
    rounded to the compute dtype before the float32 Dense.
  * ``STLModel.forward`` runs the product tower on ``pos`` and then on
    ``neg``: two sets of batch statistics, and in training two running
    updates, ``pos`` first.
  * ``train=False`` (eval, serving) normalises with the running
    statistics and updates nothing.
  * on a data mesh (:meth:`STLModel.set_data_mesh`, more than one data
    row) the batch statistics are the global batch's, as the reference's
    single GSPMD program computes them: each rank's sum and sum of
    squares are summed over the data group (an all-reduce whose backward
    is the all-reduce of the gradients), so the running statistics stay
    equal on every rank. The local batches are of equal size.

Images come in NHWC (the pipeline's layout) and are viewed as NCHW in
``channels_last`` memory. Init is flax's ``lecun_normal`` (a normal of
variance 1/fan_in truncated at two sigma) drawn from an explicit
``torch.Generator``; biases zero, scales one, running mean 0 and var 1.
A float32 tower on a card needs TF32 off for convs and matmuls
(:func:`pin_full_f32`), as the reference computes them in full float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from esrecsys_tpu_torch.models.txt2url import _truncated_normal

DEFAULT_FILTERS = (16, 32, 64, 128)
BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def pin_full_f32() -> None:
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls in this
    process (the float32 towers' products in full float32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _require_full_f32(x: torch.Tensor, conv: bool) -> None:
    """Raise where a float32 conv (``conv``) or matmul on a card would run
    in TF32."""
    tf32 = (torch.backends.cudnn.allow_tf32 if conv
            else torch.backends.cuda.matmul.allow_tf32)
    if x.is_cuda and x.dtype == torch.float32 and tf32:
        raise RuntimeError(
            "float32 image towers on a card need TF32 off for convs and "
            "matmuls: call models.cnn.pin_full_f32() first")


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax's SAME padding of one axis: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``x`` (N, C, H, W) zero-padded for a SAME k x k window at stride s."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, each op rounded to it."""
    return x * torch.sigmoid(x)


class Conv(nn.Module):
    """flax's ``nn.Conv`` on an input already padded: ``kernel`` (out, in,
    kh, kw) and ``bias`` (out,), float32 parameters, computed in the
    input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int,
                 device=None, generator=None):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(_truncated_normal(
            (out_ch, in_ch, k, k), math.sqrt(1.0 / (in_ch * k * k)),
            generator, device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _require_full_f32(x, conv=True)
        y = F.conv2d(x, self.kernel.to(x.dtype), None, self.stride)
        return y + self.bias.to(x.dtype)[None, :, None, None]


class _SumOverData(torch.autograd.Function):
    """An all-reduce SUM over a mesh's data group, differentiable: every
    rank's loss reads the sum, so each input's gradient is the sum of the
    ranks' gradients of the sum."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.sum_data(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_data(g.clone()), None


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(use_bias=False)`` over the channel axis;
    global-batch statistics on a data mesh (``data_mesh``)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.data_mesh = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mesh = self.data_mesh
        if train and mesh is not None and mesh.n_data > 1:
            n = xf.shape[0] * xf.shape[2] * xf.shape[3] * mesh.n_data
            sums = _SumOverData.apply(torch.stack(
                [xf.sum((0, 2, 3)), torch.square(xf).sum((0, 2, 3))]), mesh)
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - torch.square(mean), min=0.0)
        elif train:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp(torch.square(xf).mean((0, 2, 3))
                              - torch.square(mean), min=0.0)
        if train:
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1.0 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return y.to(x.dtype)


class ResidualStage(nn.Module):
    """One 4x-downsampling stage."""

    def __init__(self, in_ch: int, filters: int, device=None,
                 generator=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, 2, device, generator)
        self.Conv_1 = Conv(in_ch, filters, 3, 2, device, generator)
        self.Conv_2 = Conv(filters, filters, 1, 1, device, generator)
        self.Conv_3 = Conv(filters, filters, 1, 1, device, generator)
        self.BatchNorm_0 = BatchNorm(filters, device)
        self.BatchNorm_1 = BatchNorm(filters, device)
        self.BatchNorm_2 = BatchNorm(filters, device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xp = pad_same(x, 3, 2)
        residual = self.Conv_0(xp)
        y = swish(self.BatchNorm_0(self.Conv_1(xp), train))
        y = swish(self.BatchNorm_1(self.Conv_2(y), train))
        y = self.BatchNorm_2(self.Conv_3(y), train)
        y = y + residual
        return F.avg_pool2d(pad_same(y, 3, 2), 3, 2)


class Dense(nn.Module):
    """flax's ``nn.Dense`` in float32: ``kernel`` (out, in), ``bias``."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_truncated_normal(
            (out_features, in_features), math.sqrt(1.0 / in_features),
            generator, device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _require_full_f32(x, conv=False)
        return x @ self.kernel.T + self.bias


class ImageTower(nn.Module):
    """Conv stages -> spatial mean -> Dense embedding (float32 out)."""

    def __init__(self, output_size: int,
                 filters: Sequence[int] = DEFAULT_FILTERS,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        chans = (3,) + tuple(filters)
        for i, f in enumerate(filters):
            self.add_module(f"ResidualStage_{i}", ResidualStage(
                chans[i], f, device, generator))
        self.num_stages = len(filters)
        self.Dense_0 = Dense(chans[-1], output_size, device, generator)

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        """``images`` (B, H, W, 3) float32, NHWC -> (B, output_size)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # channels_last view
        for i in range(self.num_stages):
            x = getattr(self, f"ResidualStage_{i}")(x, train)
        wide = torch.promote_types(self.dtype, torch.float32)
        x = x.to(wide).mean((2, 3)).to(self.dtype).to(wide)
        return self.Dense_0(x)


class STLModel(nn.Module):
    """The two-tower scene -> product scorer."""

    def __init__(self, output_size: int,
                 filters: Sequence[int] = DEFAULT_FILTERS,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_size = output_size
        self.filters = tuple(filters)
        self.data_mesh = None
        self.scene_tower = ImageTower(output_size, filters, dtype, device,
                                      generator)
        self.product_tower = ImageTower(output_size, filters, dtype, device,
                                        generator)

    def set_data_mesh(self, mesh) -> None:
        """Take global-batch BatchNorm statistics over ``mesh``'s data
        group from now on (None: this rank's batch)."""
        self.data_mesh = mesh
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.data_mesh = mesh

    def scene_embed(self, scene: torch.Tensor) -> torch.Tensor:
        return self.scene_tower(scene, train=False)

    def product_embed(self, product: torch.Tensor) -> torch.Tensor:
        return self.product_tower(product, train=False)

    def forward(self, scene: torch.Tensor, pos_product: torch.Tensor,
                neg_product: torch.Tensor, train: bool = True):
        """(pos_score, neg_score, scene_embed, pos_embed, neg_embed)."""
        scene_e = self.scene_tower(scene, train)
        pos_e = self.product_tower(pos_product, train)
        neg_e = self.product_tower(neg_product, train)
        return ((scene_e * pos_e).sum(-1), (scene_e * neg_e).sum(-1),
                scene_e, pos_e, neg_e)
