"""Feature extraction: ``api.extract_features`` over a pool of images on the
card, pass after pass, in eval mode.

Set-up renders the mix's pool of uint8 images on the card from the seed
(they stay there) and cuts it into batches of ``batch``, the last padded by
repeating its final image and masked, as ``DeviceRenderer.batches`` feeds
an extract; builds the configuration's model with the benchmark's weights
and warms it up on two batches. The window runs whole passes until
``--seconds`` have passed; ``extract_img_per_s`` is real images over the
window, which ends in a synchronise. The last pass's embeddings of every
image are judged against the plain reference's fp32 forward of the same
images: the worst distance between the program's and the reference's
L2-normalised part embeddings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.frozen.features import identities
from benchmark.frozen.flops import forward_flops
from benchmark.frozen.render import render_pool
from benchmark.program import build_model
from benchmark.reference import resnet as ref
from benchmark.weights import make_state


def setup(cell):
    cfg, mix, dev = cell.config, cell.mix, cell.device
    gen = torch.Generator(device=dev).manual_seed(cell.sub("data"))
    n, b = mix["images"], mix["batch"]
    assign = identities(gen, n, mix["identities"], mix["skew"], dev)
    pool, cams = render_pool(gen, assign, mix["identities"], mix["cameras"], cfg["height"],
                             cfg["width"])
    pids, cams = assign.cpu().numpy(), cams.cpu().numpy()
    batches = []
    for s in range(0, n, b):
        e = min(s + b, n)
        images = pool[s:e]
        if e - s < b:
            images = torch.cat([images, images[-1:].expand(b - (e - s), -1, -1, -1)])
        idx = np.minimum(np.arange(s, s + b), n - 1)
        batches.append((images, pids[idx], cams[idx], np.arange(s, s + b) < n))
    state = make_state(cfg, torch.Generator(device=dev).manual_seed(cell.sub("weights")))
    model = build_model(cfg, state, dev)
    del state
    st = {"pool": pool, "batches": batches, "model": model, "feats": None}
    _pass(cell, st, batches[:2])
    return st


def _pass(cell, st, batches):
    from ssg_tpu_torch import api

    feats, _, _, _ = api.extract_features(st["model"], batches, device=cell.device)
    return feats


def window(cell, st, seconds: float) -> dict:
    on_card = cell.device.type == "cuda"
    t0 = time.perf_counter()
    passes, units = 0, []
    while True:
        st["feats"] = _pass(cell, st, st["batches"])
        passes += 1
        units.append(time.perf_counter() - t0 - sum(units))
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = cell.mix["images"]
    failed = int((~torch.isfinite(st["feats"]).all(2).all(0)).sum())
    return {"metrics": {"extract_img_per_s": passes * n / elapsed}, "attempted": passes * n,
            "failed": failed, "units": units}


def traced_slice(cell, st) -> dict:
    """One whole pass, as the window runs them."""
    _pass(cell, st, st["batches"])
    return {"flops": cell.mix["images"] * forward_flops(cell.config)}


def collect(cell, st) -> dict:
    return {"feats": st["feats"].cpu(), "pool": st["pool"]}


def reference(cell, pool, quant=None, block: int = 256) -> torch.Tensor:
    """The reference's (num_parts, N, F) eval embeddings of the pool."""
    dev, cfg = cell.device, cell.config
    p = make_state(cfg, torch.Generator(device=dev).manual_seed(cell.sub("weights")))
    out = []
    with torch.no_grad(), ref.fp32_mode():
        for s in range(0, pool.shape[0], block):
            x = ref.normalize(pool[s:s + block].to(dev).float())
            out.append(ref.forward(p, cfg, x, train=False, quant=quant).cpu())
    return torch.cat(out, 1)


def readings(prog: torch.Tensor, ref_: torch.Tensor) -> dict:
    """The worst distance of a part embedding from the reference's."""
    return {"emb_gap": float((prog.float() - ref_).norm(dim=2).max())}


def check(cell, out) -> tuple[dict, dict]:
    return readings(out["feats"], reference(cell, out["pool"])), {}


def control(cell, out) -> dict:
    """The reference in fp8 put in the program's place."""
    return readings(reference(cell, out["pool"], quant="fp8"), reference(cell, out["pool"]))
