"""Plain fp32 SSG ViT from a state dict: its forward, the train crop, the
batch-hard triplet loss and AdamW.

Kept byte for byte in two places: ``ssg_tpu_torch/reference/vit.py``, which
the CPU tests hold ``models.vit.SSGViT`` to, and ``benchmark/reference/
vit.py``, which decides a benchmark cell's ``correct``. It imports torch
alone.

Follows the published description: ViT-Base (Dosovitskiy et al. 2020,
arXiv:2010.11929, Table 1) with TransReID's overlapping patch embedding (He
et al. 2021, arXiv:2102.04378): a ``patch_size`` convolution at
``patch_stride`` with no padding and a bias, a class token in front, learned
position embeddings added; ``num_hidden_layers`` pre-norm blocks, each
``x + attention(LN(x))`` then ``x + MLP(LN(x))``, with LayerNorm at
``layer_norm_eps`` (biased variance), multi-head self-attention of
``num_attention_heads`` heads (one qkv linear with its bias, softmax of
``q k^T / sqrt(head_dim)``, an output linear) and an MLP of two linears
around the exact-erf GELU; a final LayerNorm. State-dict names are timm's
under ``backbone.``. Departures, for SSG: the SSG heads of Fu et al. 2019
(arXiv:1811.10144) in place of TransReID's BNNeck and classifier: the
final class token ("whole"), and the means of the upper and lower halves of
the patch grid (rows ``[:max(h // 2, 1)]`` and ``[h // 2:]``), each through
its own BatchNorm1d (eps 1e-5; the batch's statistics with the biased
variance in train mode, the running ones in eval mode), L2-normalised in
eval mode; no camera embedding (SIE) and no jigsaw branch (JPM); drop-path
0, so a train step is deterministic.

The train transform is RandomSizedRectCrop and flip from five uniform
draws per image (area U(0.64, 1) of H x W, aspect h / w U(2, 3), each side
clipped to [1, side], the corner at U(0, 1) of the slack, a flip below 0.5),
resampled bilinearly with an antialiasing triangle widened by the shrink
factor, then ImageNet-normalised. The batch-hard triplet loss takes, per
anchor, the farthest positive and nearest negative among rows of label >=
0, over anchors that have both; AdamW is written out by hand (decoupled
weight decay, eps outside the root), over every floating-point entry but
the running statistics.

Everything computes in fp32, with TF32 off (``fp32_mode``). ``quant="fp8"``
makes it the control: the operands of the patch convolution, of every
linear and of attention's two products (q and k; the probabilities and v)
are rounded to float8 e4m3 with a per-tensor scale (amax to 448) before the
product, the precision below the model's bf16.
"""

from __future__ import annotations

import contextlib
import math

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


def _linear(x, p, name, quant):
    w = p[f"{name}.weight"]
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    return x @ w.t() + p[f"{name}.bias"]


def _layer_norm(x, p, name, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p[f"{name}.weight"] + p[f"{name}.bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _attention(x, p, name, heads, quant):
    b, t, c = x.shape
    qkv = _linear(x, p, f"{name}.qkv", quant).view(b, t, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, heads, T, head_dim)
    if quant == "fp8":
        q, k = _fp8(q), _fp8(k)
    a = (q @ k.transpose(-1, -2) / math.sqrt(c // heads)).softmax(-1)
    if quant == "fp8":
        a, v = _fp8(a), _fp8(v)
    y = (a @ v).transpose(1, 2).reshape(b, t, c)
    return _linear(y, p, f"{name}.proj", quant)


def _bn(x, p, name, train):
    if train:
        mean, var = x.mean(0), x.var(0, unbiased=False)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + 1e-5) * p[f"{name}.weight"] + p[f"{name}.bias"]


def forward(p: dict, config: dict, x: torch.Tensor, train: bool, quant: str | None = None):
    """NHWC normalised fp32 images -> (num_parts, B, F) embeddings, raw in
    train mode and L2-normalised in eval mode."""
    eps, heads = config["layer_norm_eps"], config["num_attention_heads"]
    x = x.permute(0, 3, 1, 2)
    w = p["backbone.patch_embed.proj.weight"]
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    x = F.conv2d(x, w, p["backbone.patch_embed.proj.bias"], config["patch_stride"])
    b, c, gh, gw = x.shape
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p["backbone.cls_token"].expand(b, -1, -1), x], 1) + p["backbone.pos_embed"]
    for i in range(config["num_hidden_layers"]):
        q = f"backbone.blocks.{i}"
        x = x + _attention(_layer_norm(x, p, f"{q}.norm1", eps), p, f"{q}.attn", heads, quant)
        h = _layer_norm(x, p, f"{q}.norm2", eps)
        x = x + _linear(_gelu(_linear(h, p, f"{q}.mlp.fc1", quant)), p, f"{q}.mlp.fc2", quant)
    x = _layer_norm(x, p, "backbone.norm", eps)
    grid = x[:, 1:].reshape(b, gh, gw, c)
    pools = [x[:, 0], grid[:, :max(gh // 2, 1)].mean((1, 2)), grid[:, gh // 2:].mean((1, 2))]
    out = []
    for part, y in zip(PART_NAMES, pools[:config["num_parts"]]):
        if config.get("num_features", 0) > 0:
            y = y @ p[f"feat_{part}.weight"].t() + p[f"feat_{part}.bias"]
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
    {name: tensor}, and the ``params`` after the last step."""
    names = [n for n, t in p0.items() if t.is_floating_point()
             and not n.endswith(("running_mean", "running_var"))]
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
