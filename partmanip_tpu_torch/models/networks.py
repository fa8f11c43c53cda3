"""Policy/value networks (``torch.nn``).

Counterpart of ``partmanip_tpu/models/networks.py``: ``MLP``, ``PointNet``,
``Conv3DNet``, ``PoolConv3DNet``, and the image students ``ResNet`` (RGB)
and ``depthResNet`` (depth) on a ResNet-34 backbone.  Activation from
config, orthogonal init of the dense layers with the stable-baselines gain
schedule (√2 hidden, 0.01 policy head, 1 value head), zero biases; the
convolutions take flax's default init (LeCun normal, truncated at two
standard deviations).

The 3-D nets hold their volumes as NCDHW where the JAX package's are NDHWC;
``vol.reshape(b, 1, r, r, r)`` keeps its voxel order, and the conv features
are permuted to (D, H, W, C) before they are flattened, so that the dense
layer after them reads its inputs in the JAX package's order and its weight
converts as every other dense layer's does.  The JAX nets compute in full
f32 (their convolutions take no compute dtype).  On the GPU cuDNN computes
f32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False; the modules leave that process-wide flag to their caller, and the
port's entry points (``train_torch.py``, ``collect_demos_torch.py``) set it
False, so that there forward and backward convolutions round as f32 ones.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import point_pool


def get_activation(name: str) -> Callable:
    return {
        "elu": F.elu, "selu": F.selu, "relu": F.relu, "crelu": F.relu,
        "lrelu": F.leaky_relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
    }[name]


def _init_dense(layer: nn.Linear, gain: float) -> None:
    """Orthogonal weight (drawn on the CPU from the global generator, so a
    seed gives the same weights on every device), zero bias."""
    w = torch.empty(layer.weight.shape)
    nn.init.orthogonal_(w, gain)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.zero_()


def _compute_dtype(net_cfg: dict, default: str = "bf16"):
    """Compute dtype of the dense stack.  ``bf16`` (default for MLP) runs the
    matmuls under bf16 autocast while parameters stay f32; ``dtype: f32``
    restores exact f32 numerics."""
    v = net_cfg.get("dtype", default)
    table = {"bf16": torch.bfloat16, "f32": None}
    if v not in table:
        raise ValueError(f"network.dtype must be one of {sorted(table)}, "
                         f"got {v!r}")
    return table[v]


class MLP(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.dtype = _compute_dtype(net_cfg)
        dims = [input_dim] + list(net_cfg["hid_dim"])
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.head = nn.Linear(dims[-1], output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        for layer in self.hidden:
            _init_dense(layer, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def _stack(self, x):
        for layer in self.hidden:
            x = self.act(layer(x))
        return self.head(x)

    def forward(self, x):
        if self.dtype is None:
            return self._stack(x)
        with torch.autocast(device_type=x.device.type, dtype=self.dtype):
            y = self._stack(x)
        # heads read in f32 downstream (log-prob/KL/value math)
        return y.float()


class PointNet(nn.Module):
    """[B, point_num·C (+ proprio)] point clouds → shared per-point MLP
    128-256-512 (no activation after 512) → max (or max ‖ mean) pool →
    (‖ proprio) → 128 → 32 → head.  Computes in f32, as the JAX package's
    PointNet does (its dense layers take no compute dtype): the ``dtype``
    key of the config, the MLP's bf16 switch, does not apply.

    The max pool and the 512-wide layer before it are one op
    (``ops/point_pool.linear_max_pool``), whose backward reads only the
    argmax points; ``pool_counters`` sums what its backward passes saw.
    With ``max_mean`` the mean's gradient reaches every point, so that pool
    stays ``Linear`` + ``amax`` ‖ ``mean``."""

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0, point_num: int = 1024):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.max_mean = bool(net_cfg.get("max_mean", False))
        self.sub_mean = bool(net_cfg.get("sub_mean", False))
        self.proprio_shape = int(proprio_shape)
        self.point_num = int(point_num)
        channels, rest = divmod(input_dim - self.proprio_shape, self.point_num)
        if rest or channels < 1:
            raise ValueError(f"PointNet input {input_dim} is not {point_num} "
                             f"points (+ {proprio_shape} proprio)")
        dims = [channels, 128, 256, 512]
        self.point = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        pooled = 512 * (2 if self.max_mean else 1) + self.proprio_shape
        self.hidden = nn.ModuleList([nn.Linear(pooled, 128), nn.Linear(128, 32)])
        self.head = nn.Linear(32, output_dim)
        self.pool_counters = point_pool.PoolCounters()
        self.reset_parameters()

    def reset_parameters(self):
        for layer in (*self.point, *self.hidden):
            _init_dense(layer, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        b = x.shape[0]
        if self.proprio_shape:
            proprio = x[:, -self.proprio_shape:]
            pc = x[:, :-self.proprio_shape].reshape(b, self.point_num, -1)
        else:
            proprio = None
            pc = x.reshape(b, self.point_num, -1)
        if self.sub_mean:
            xyz = pc[..., :3]
            pc = torch.cat([xyz - xyz.mean(dim=1, keepdim=True), pc[..., 3:]], dim=-1)
        h = pc
        for layer in self.point[:-1]:
            h = self.act(layer(h))
        last = self.point[-1]
        if self.max_mean:
            h = last(h)
            h = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        else:
            h = point_pool.linear_max_pool(h, last.weight, last.bias, self.pool_counters)
        if proprio is not None:
            h = torch.cat([h, proprio], dim=-1)
        for layer in self.hidden:
            h = self.act(layer(h))
        return self.head(h)


def _init_conv(layer) -> None:
    """flax's default conv init: LeCun normal (variance 1 / fan_in, truncated
    at ±2σ and rescaled to keep the variance), zero bias where the layer has
    one; drawn on the CPU like :func:`_init_dense`."""
    w = torch.empty(layer.weight.shape)
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)
    with torch.no_grad():
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.zero_()


def _cube_side(n: int, what: str) -> int:
    r = round(n ** (1 / 3))
    if r ** 3 != n:
        raise ValueError(f"{what}: {n} inputs are not a cube of voxels")
    return r


class _Conv3DStack(nn.Module):
    """A volume [b, r³] (x-major voxel order, as the JAX package flattens
    its NDHWC volumes) → strided 3-D convs with symmetric padding k // 2 and
    the activation → (optionally max-pooled) features flattened in
    (D, H, W, C) order."""

    def __init__(self, res: int, layers, act, pool: int = 0):
        super().__init__()
        self.res, self.act, self.pool = res, act, pool
        self.convs = nn.ModuleList()
        c, side = 1, res
        for f, k, s in layers:
            self.convs.append(nn.Conv3d(c, f, k, stride=s, padding=k // 2))
            c, side = f, (side + 2 * (k // 2) - k) // s + 1
        if pool:
            side = (side - pool) // pool + 1
        if side < 1:
            raise ValueError(f"a {res}³ volume shrinks to nothing in {layers}"
                             + (f" and a {pool}³ pool" if pool else ""))
        self.out_features = c * side ** 3

    def reset_parameters(self):
        for conv in self.convs:
            _init_conv(conv)

    def forward(self, vol):
        b, r = vol.shape[0], self.res
        v = vol.reshape(b, 1, r, r, r)
        for conv in self.convs:
            v = self.act(conv(v))
        if self.pool:
            v = F.max_pool3d(v, self.pool, stride=self.pool)
        return v.permute(0, 2, 3, 4, 1).reshape(b, -1)


class Conv3DNet(nn.Module):
    """TSDF volume r³ (+ proprio) → convs 16 / 32 / 32, kernels 5 / 3 / 3,
    strides 3 / 3 / 2 (50 → 17 → 6 → 3) → flatten (‖ proprio) → 256 →
    head."""

    LAYERS = ((16, 5, 3), (32, 3, 3), (32, 3, 2))

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.proprio_shape = int(proprio_shape)
        res = _cube_side(input_dim - self.proprio_shape,
                         f"Conv3DNet input {input_dim} less {proprio_shape} proprio")
        self.stack = _Conv3DStack(res, self.LAYERS, self.act)
        self.hidden = nn.Linear(self.stack.out_features + self.proprio_shape, 256)
        self.head = nn.Linear(256, output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        self.stack.reset_parameters()
        _init_dense(self.hidden, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        if self.proprio_shape:
            v = self.stack(x[:, :-self.proprio_shape])
            v = torch.cat([v, x[:, -self.proprio_shape:]], dim=-1)
        else:
            v = self.stack(x)
        return self.head(self.act(self.hidden(v)))


class PoolConv3DNet(nn.Module):
    """Volume r³ → convs 16 / 32 / 64, kernels 5 / 3 / 3, stride 2 → 4³ max
    pool → flatten → 32 → head.  Like the JAX net it reshapes its whole
    input as the volume, so it takes no proprio: an input that is not a cube
    raises ``ValueError`` (where the JAX net fails in the reshape)."""

    LAYERS = ((16, 5, 2), (32, 3, 2), (64, 3, 2))

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        res = _cube_side(input_dim, f"PoolConv3DNet input {input_dim} (it takes "
                         f"no proprio; {proprio_shape} given)")
        self.stack = _Conv3DStack(res, self.LAYERS, self.act, pool=4)
        self.hidden = nn.Linear(self.stack.out_features, 32)
        self.head = nn.Linear(32, output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        self.stack.reset_parameters()
        _init_dense(self.hidden, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        return self.head(self.act(self.hidden(self.stack(x))))


class FrozenBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)``, the only way the JAX
    package applies its ResNets (every ``apply`` there leaves ``train`` at
    False): ``(x − mean) · (rsqrt(var + 1e-5) · scale) + bias`` per channel
    of an NCHW tensor, in flax's order of operations.  No mode flag changes
    it: ``.train()`` neither normalises by the batch nor updates ``mean`` /
    ``var``.  All four are parameters, because the JAX package's optimizer
    steps them all: its gradient is taken over the whole variables dict,
    ``batch_stats`` included, and the statistics enter the output."""

    EPS = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def reset_parameters(self):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        view = lambda t: t.view(1, -1, 1, 1)
        mul = torch.rsqrt(self.var + self.EPS) * self.scale
        return (x - view(self.mean)) * view(mul) + view(self.bias)


def _conv2d(c_in, c_out, k, stride, padding=0):
    """A bias-free 2-D conv left uninitialised (``reset_parameters`` of the
    network draws every weight, so PyTorch's own init of 21 M weights would
    be thrown away)."""
    return nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride, padding=padding, bias=False)


class _BasicBlock(nn.Module):
    """3×3 conv (stride s) → BN → relu → 3×3 conv → BN, plus the input (a
    1×1 conv of stride s → BN where the width or the stride changes), relu.
    Paddings as flax's: explicit 1 for the 3×3 convs; ``SAME`` for the 1×1,
    which pads nothing at any input size."""

    def __init__(self, c_in: int, features: int, stride: int):
        super().__init__()
        self.conv0 = _conv2d(c_in, features, 3, stride, padding=1)
        self.bn0 = FrozenBatchNorm(features)
        self.conv1 = _conv2d(features, features, 3, 1, padding=1)
        self.bn1 = FrozenBatchNorm(features)
        self.down = c_in != features or stride != 1
        if self.down:
            self.conv2 = _conv2d(c_in, features, 1, stride)
            self.bn2 = FrozenBatchNorm(features)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        if self.down:
            x = self.bn2(self.conv2(x))
        return F.relu(x + y)


class ResNet34Backbone(nn.Module):
    """7×7 conv, stride 2, padding 3 → BN → relu → 3×3 max pool, stride 2,
    padding 1 (−inf) → 3 / 4 / 6 / 3 basic blocks of 64 / 128 / 256 / 512
    (the first of each later stage of stride 2) → global average pool →
    [B, 512].  NCHW shapes throughout (in channels-last memory on the
    GPU)."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv0 = _conv2d(in_channels, 64, 7, 2, padding=3)
        self.bn0 = FrozenBatchNorm(64)
        blocks, c = [], 64
        for features, n, stride in self.STAGES:
            for i in range(n):
                blocks.append(_BasicBlock(c, features, stride if i == 0 else 1))
                c = features
        self.blocks = nn.ModuleList(blocks)

    def reset_parameters(self):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _init_conv(m)
            elif isinstance(m, FrozenBatchNorm):
                m.reset_parameters()

    def forward(self, x):
        if x.is_cuda:
            # channels-last activations on the GPU: cuDNN then takes its
            # NHWC implicit-GEMM kernels (for NCHW it picks FFT weight
            # gradients).  Either layout is f32 to within rounding; on
            # image rows a ReLU or the stem's pool may take the other
            # branch of a near-tie in either.  A one-channel image is both
            # layouts at once and reads as NCHW unless its channel stride
            # is 1.
            x = x.contiguous(memory_format=torch.channels_last)
            if x.shape[1] == 1:
                x = x.as_strided(x.shape, (x.stride(0), 1, x.stride(2), x.stride(3)))
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        return x.mean(dim=(2, 3))


class ResNet(nn.Module):
    """An image of ``in_channels`` × h × w (flattened channel-first, as the
    image observations are) (+ proprio, the last ``proprio_shape`` columns)
    → ResNet-34 backbone → (‖ proprio) → 128 → 32 → head, in f32.  The JAX
    net transposes its image to NHWC for XLA; this one keeps NCHW, so only
    the conv kernels change layout in the converter (HWIO → OIHW)."""

    IN_CHANNELS = 3

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0, h: int = 72, w: int = 128):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.proprio_shape = int(proprio_shape)
        self.in_channels, self.h, self.w = self.IN_CHANNELS, int(h), int(w)
        if input_dim != self.in_channels * self.h * self.w + self.proprio_shape:
            raise ValueError(
                f"{type(self).__name__} takes {self.in_channels} × {self.h} × "
                f"{self.w} image values + {proprio_shape} proprio, not {input_dim} inputs")
        self.backbone = ResNet34Backbone(self.in_channels)
        self.hidden = nn.ModuleList([nn.Linear(512 + self.proprio_shape, 128),
                                     nn.Linear(128, 32)])
        self.head = nn.Linear(32, output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        self.backbone.reset_parameters()
        for layer in self.hidden:
            _init_dense(layer, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        b = x.shape[0]
        if self.proprio_shape:
            proprio = x[:, -self.proprio_shape:]
            img = x[:, :-self.proprio_shape]
        else:
            proprio, img = None, x
        f = self.backbone(img.reshape(b, self.in_channels, self.h, self.w))
        if proprio is not None:
            f = torch.cat([f, proprio], dim=-1)
        for layer in self.hidden:
            f = self.act(layer(f))
        return self.head(f)


class depthResNet(ResNet):
    """:class:`ResNet` on a one-channel depth image."""

    IN_CHANNELS = 1


def load_resnet34_pretrained(net: ResNet, npz_path: str) -> None:
    """Graft converted ImageNet ResNet-34 weights (the ``.npz`` that
    ``tools/resnet_convert.py`` writes: flax paths ``params/<scope>/...`` and
    ``batch_stats/<scope>/...``) into ``net``'s backbone, in place; the dense
    layers keep their values.  A one-channel (depth) stem takes the RGB stem
    kernel summed over its input channels, as the JAX package's loader
    does."""
    import numpy as np
    from ..utils.convert import resnet_backbone_names

    flat = dict(np.load(npz_path))
    params = dict(net.backbone.named_parameters())
    with torch.no_grad():
        for flax_path, name, kind in resnet_backbone_names(
                [b.down for b in net.backbone.blocks]):
            v = torch.as_tensor(np.asarray(flat[flax_path], np.float32))
            if kind == "kernel":
                v = v.permute(3, 2, 0, 1)            # HWIO → OIHW
                cur = params[name]
                if v.shape != cur.shape:
                    if not (cur.shape[1] == 1 and v.shape[1] == 3):
                        raise ValueError(f"{flax_path}: {tuple(v.shape)} for {tuple(cur.shape)}")
                    v = v.sum(dim=1, keepdim=True)
            params[name].copy_(v)


NETWORKS = {"MLP": MLP, "PointNet": PointNet, "Conv3DNet": Conv3DNet,
            "PoolConv3DNet": PoolConv3DNet, "ResNet": ResNet, "depthResNet": depthResNet}


def make_network(name: str, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0) -> nn.Module:
    return NETWORKS[name](input_dim, output_dim, net_cfg, proprio_shape)
