"""The paper's own models (VGG-19, ResNet-152) as per-layer cost tables
for the partitioner, and a small runnable conv net (the port of
repro.models.cnn).

The cost tables are (flops fwd+bwd, param_bytes, act_bytes) per layer,
derived analytically from the published architectures at 224x224 (VGG-19:
19.6 GFLOPs/image, 548 MB params; ResNet-152: 11.3 GFLOPs, 230 MB), the
models the paper trains (Section 8.1). They are numpy: the partitioner
(core.partition) and the allocator (core.allocation) take numpy arrays.

The conv net keeps the JAX package's layouts as its interface: images
NHWC [B, 32, 32, 3], kernels HWIO [3, 3, in, out]; tiny_cnn_apply permutes
to torch's NCHW / OIHW inside and nowhere else.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19_layer_costs(batch: int = 32):
    """Per-layer (flops fwd+bwd, param_bytes, act_bytes) at 224x224."""
    h = w = 224
    cin = 3
    fl, pb, ab = [], [], []
    for v in VGG19_CFG:
        if v == "M":
            h //= 2
            w //= 2
            continue
        f = 2 * batch * h * w * cin * v * 9            # 3x3 conv
        fl.append(3.0 * f)
        pb.append(cin * v * 9 * 4.0)
        ab.append(batch * h * w * v * 4.0)
        cin = v
    # classifier: 25088->4096->4096->1000 (the bulk of VGG's 548MB)
    for din, dout in ((512 * 49, 4096), (4096, 4096), (4096, 1000)):
        fl.append(3.0 * 2 * batch * din * dout)
        pb.append(din * dout * 4.0)
        ab.append(batch * dout * 4.0)
    return np.array(fl), np.array(pb), np.array(ab)


def resnet152_layer_costs(batch: int = 32):
    """Bottleneck-block granularity (stem, 3/8/36/3 blocks, classifier)."""
    stages = [(256, 64, 3, 56), (512, 128, 8, 28),
              (1024, 256, 36, 14), (2048, 512, 3, 7)]
    fl, pb, ab = [], [], []
    fl.append(3.0 * 2 * batch * 112 * 112 * 3 * 64 * 49)     # 7x7 stem
    pb.append(3 * 64 * 49 * 4.0)
    ab.append(batch * 112 * 112 * 64 * 4.0)
    for cout, mid, blocks, hw in stages:
        for b in range(blocks):
            cin = cout if b else (cout // 2 if cout > 256 else 64)
            f = 2 * batch * hw * hw * (cin * mid + mid * mid * 9 + mid * cout)
            p = (cin * mid + mid * mid * 9 + mid * cout) * 4.0
            fl.append(3.0 * f)
            pb.append(p)
            ab.append(batch * hw * hw * cout * 4.0)
    fl.append(3.0 * 2 * batch * 2048 * 1000)
    pb.append(2048 * 1000 * 4.0)
    ab.append(batch * 1000 * 4.0)
    return np.array(fl), np.array(pb), np.array(ab)


PAPER_MODELS = {"vgg19": vgg19_layer_costs, "resnet152": resnet152_layer_costs}


# ---- small runnable conv net -------------------------------------------
def init_tiny_cnn(generator: torch.Generator, num_classes: int = 10,
                  width: int = 8, *, device="cpu"):
    """Random params of the JAX package's four leaves and layouts (c1, c2
    HWIO kernels, w [2 width 64, classes], b), drawn from `generator`
    (which must live on `device`); the draws differ from jax.random's, so
    parity tests carry JAX's leaves across with cnn_params_from_numpy."""
    def normal(*shape):
        return 0.1 * torch.randn(shape, generator=generator, device=device)
    return {"c1": normal(3, 3, 3, width),
            "c2": normal(3, 3, width, 2 * width),
            "w": normal(2 * width * 64, num_classes),
            "b": torch.zeros(num_classes, device=device)}


def cnn_params_from_numpy(tree, *, device, dtype=torch.float32):
    """The JAX package's tiny-CNN params (numpy arrays, e.g.
    `jax.device_get(p)`) -> the same leaves as `dtype` tensors on
    `device`, layouts unchanged."""
    return {k: torch.from_numpy(np.array(np.asarray(v), np.float32)).to(
        device=device, dtype=dtype) for k, v in tree.items()}


def _conv_relu_pool(y, kernel_hwio):
    """NCHW y, an HWIO kernel: 'SAME' 3x3 conv (stride 1), relu, 2x2 max
    pool (stride 2, 'VALID')."""
    y = F.conv2d(y, kernel_hwio.permute(3, 2, 0, 1), padding="same")
    return F.max_pool2d(F.relu(y), 2, 2)


def tiny_cnn_apply(p, x):
    """x [B, 32, 32, 3] (NHWC) -> logits [B, classes]."""
    y = _conv_relu_pool(x.permute(0, 3, 1, 2), p["c1"])
    y = _conv_relu_pool(y, p["c2"])
    # flatten in the JAX package's NHWC order, so p["w"] rows line up
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1) @ p["w"] + p["b"]
