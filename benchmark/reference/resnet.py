"""Plain fp32 SSG ResNet, its test and train transforms, the batch-hard
triplet loss and AdamW, from a state dict.

Follows the published description: He et al. 2015 (arXiv:1512.03385),
Bottleneck ResNets in torchvision's layout (7x7/2 stem, 3x3/2 max-pool,
stage strides 1, 2, 2, ``last_stride``), with the SSG heads of Fu et al.
2019 (arXiv:1811.10144): the conv5 map average-pooled whole, upper half and
lower half, each through its own BatchNorm1d; in eval mode each part's
embedding is L2-normalised. BatchNorm eps 1e-5. Train mode normalises with
the batch's statistics (biased variance); running statistics are not kept.

The train transform is the reference's RandomSizedRectCrop and flip from
five uniform draws per image (area U(0.64, 1) of H x W, aspect h / w
U(2, 3), each side clipped to [1, side], the corner at U(0, 1) of the
slack, a flip below 0.5), resampled bilinearly with an antialiasing
triangle widened by the shrink factor (``jax.image.scale_and_translate``'s
rule), then ImageNet-normalised. The batch-hard triplet loss takes, per
anchor, the farthest positive and nearest negative among rows of label >=
0, over anchors that have both; AdamW is written out by hand
(decoupled weight decay, eps outside the root).

Everything computes in fp32, with TF32 off (``fp32_mode``).
``quant="fp8"`` makes it the control: every convolution's input and
weight are rounded to float8 e4m3 with a per-tensor scale (amax to 448)
before the product, the precision below the configurations' bf16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PART_NAMES = ("whole", "up", "down")
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_mode(allow_tf32: bool = False):
    """True fp32 products and convolutions (or TF32 where asked), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to e4m3 with a per-tensor scale; gradients pass straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def _conv(x, w, stride, quant):
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    k = w.shape[-1]
    return F.conv2d(x, w, None, stride, k // 2)


def _bn(x, p, name, train):
    """BatchNorm: the batch's statistics (biased variance) in train mode, the
    running ones in eval mode."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        mean, var = x.mean(dims), x.var(dims, unbiased=False)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5)
    return y * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape)


def forward(p: dict, config: dict, x: torch.Tensor, train: bool, quant: str | None = None):
    """NHWC normalised fp32 images -> (num_parts, B, F) embeddings, raw in
    train mode and L2-normalised in eval mode."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, p["backbone.conv1.weight"], 2, quant), p, "backbone.bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    stages = config["stage_sizes"]
    for s, blocks in enumerate(stages):
        stride = 1 if s == 0 else (config["last_stride"] if s == len(stages) - 1 else 2)
        for b in range(blocks):
            q = f"backbone.layer{s + 1}.{b}"
            st = stride if b == 0 else 1
            y = F.relu(_bn(_conv(x, p[f"{q}.conv1.weight"], 1, quant), p, f"{q}.bn1", train))
            y = F.relu(_bn(_conv(y, p[f"{q}.conv2.weight"], st, quant), p, f"{q}.bn2", train))
            y = _bn(_conv(y, p[f"{q}.conv3.weight"], 1, quant), p, f"{q}.bn3", train)
            if f"{q}.downsample.0.weight" in p:
                x = _bn(_conv(x, p[f"{q}.downsample.0.weight"], st, quant), p,
                        f"{q}.downsample.1", train)
            x = F.relu(y + x)
    h = x.shape[2]
    pools = [x.mean((2, 3)), x[:, :, :max(h // 2, 1)].mean((2, 3)), x[:, :, h // 2:].mean((2, 3))]
    out = []
    for part, y in zip(PART_NAMES, pools[:config["num_parts"]]):
        if config.get("num_features", 0) > 0:
            y = F.linear(y, p[f"feat_{part}.weight"], p[f"feat_{part}.bias"])
        y = _bn(y, p, f"feat_bn_{part}", train)
        if not train:
            y = y / y.norm(dim=1, keepdim=True).clamp_min(1e-12)
        out.append(y)
    return torch.stack(out)


def normalize(x255: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x255.device)
    std = torch.tensor(IMAGENET_STD, device=x255.device)
    return (x255 / 255.0 - mean) / std


def _weights(in_size: int, out_size: int, start: torch.Tensor, size: torch.Tensor):
    """(B, out_size, in_size) resampling weights of [start, start + size)."""
    o = torch.arange(out_size, dtype=torch.float32, device=start.device)
    i = torch.arange(in_size, dtype=torch.float32, device=start.device)
    pos = (o[None, :] + 0.5) * (size / out_size)[:, None] + start[:, None] - 0.5
    width = (size / out_size).clamp_min(1.0)
    w = (1.0 - (pos[:, :, None] - i[None, None, :]).abs() / width[:, None, None]).clamp_min(0.0)
    total = w.sum(2, keepdim=True)
    w = torch.where(total > 1000.0 * torch.finfo(torch.float32).eps, w / total.clamp_min(1e-30),
                    0.0)
    inside = (pos >= -0.5) & (pos <= in_size - 0.5)
    return w * inside[:, :, None]


def train_images(images_u8: torch.Tensor, u: torch.Tensor, height: int, width: int):
    """RandomSizedRectCrop + flip of uint8 NHWC images from draws u (5, B),
    normalised fp32 (B, height, width, 3)."""
    _, h, w, _ = images_u8.shape
    area = (0.64 + 0.36 * u[0]) * float(h * w)
    aspect = 2.0 + u[1]
    ch = torch.sqrt(area * aspect).clamp(1.0, float(h))
    cw = torch.sqrt(area / aspect).clamp(1.0, float(w))
    y0 = u[2] * (h - ch)
    x0 = u[3] * (w - cw)
    wy = _weights(h, height, y0, ch)
    wx = _weights(w, width, x0, cw)
    out = torch.einsum("bph,bhwc,bqw->bpqc", wy, images_u8.float(), wx)
    out = torch.where((u[4] < 0.5)[:, None, None, None], out.flip(2), out)
    return normalize(out)


def triplet(emb: torch.Tensor, labels: torch.Tensor, margin: float) -> torch.Tensor:
    """Batch-hard triplet loss over rows of label >= 0."""
    delta = emb[:, None, :] - emb[None, :, :]
    d = (delta * delta).sum(-1).clamp_min(1e-12).sqrt()
    valid = labels >= 0
    pair = valid[:, None] & valid[None, :]
    same = (labels[:, None] == labels[None, :]) & pair
    diff = ~(labels[:, None] == labels[None, :]) & pair
    not_self = ~torch.eye(len(labels), dtype=torch.bool, device=emb.device)
    anchor = valid & (same & not_self).any(1) & diff.any(1)
    d_ap = torch.where(same, d, float("-inf")).amax(1)
    d_an = torch.where(diff, d, float("inf")).amin(1)
    per = (d_ap - d_an + margin).clamp_min(0.0)
    return per[anchor].sum() / anchor.sum().clamp_min(1)


def train_steps(p0: dict, config: dict, batches, lr: float, weight_decay: float, margin: float,
                quant: str | None = None) -> dict:
    """Train steps from state ``p0`` over ``batches`` of (images_u8, labels
    (num_parts, B), u (5, B)). Returns each step's ``losses``, the first
    step's embeddings ``emb1`` (num_parts, B, F) and gradient ``grad1``
    {name: tensor}, and the ``params`` after the last step. BatchNorm
    weights and biases are trained; running statistics are left out."""
    names = [n for n in p0 if not n.endswith(("running_mean", "running_var"))]
    params = {n: p0[n].detach().clone().requires_grad_(n in names) for n in p0}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad1, emb1 = [], None, None
    for t, (images, labels, u) in enumerate(batches, start=1):
        x = train_images(images, u, config["height"], config["width"])
        emb = forward(params, config, x, train=True, quant=quant)
        loss = sum(triplet(emb[g], labels[g], margin) for g in range(emb.shape[0]))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
            emb1 = emb.detach()
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = lr / (1 - b1 ** t)
                denom = (v[n] / (1 - b2 ** t)).sqrt().add_(eps)
                params[n].mul_(1 - lr * weight_decay).addcdiv_(m[n], denom, value=-step)
    return {"losses": losses, "grad1": grad1, "emb1": emb1,
            "params": {n: params[n].detach() for n in names}}
