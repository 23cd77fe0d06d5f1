"""SSG fine-tuning of a ViT configuration: the ``train`` kind's cell
(``kinds/train.py``: the same pool, identities, labels, P x K epochs,
``Trainer.train`` and ``make_train_step``, the same checked steps, window
and comparison), with the program's SSG ViT (``program_vit.py``), its
weights (``weights_vit.py``), its plain reference (``reference/vit.py``)
and its operation counts (``frozen/vitflops.py``, ``frozen/vitwork.py``).

One reading differs: a leaf's change leaves out the key third of each qkv
bias (``_change``). Adding a constant to every key shifts each query's
logits alike, which the softmax ignores, so that third's gradient is
round-off (1e-8 of the query third's in the fp32 reference) and Adam,
which divides by its root, moves it by whatever step the round-off's sign
gives: the program's bf16 backward moves it ~0.0033 in three steps, the
reference's fp32 one ~0.0002, and the leaf's change would differ by ~20 %
where the rest of the model agrees to 0.5 % (ViT-B/16 on an H100, 20 seeds). Its
value does not change the model's output.

Metrics: ``train_img_per_s`` and ``train_step_p95_ms`` as the ``train``
kind reads them. The traced epoch also counts attention's least time
(``attention_bound_s``), which ``attention_roofline.train`` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.features import identities
from benchmark.frozen.render import render_pool
from benchmark.frozen.sampler import index_lists
from benchmark.frozen.vitflops import train_step_flops
from benchmark.frozen.vitwork import train_step_bound_s
# The harness calls ``window`` and ``collect`` of this module: the train kind's.
from benchmark.kinds.train import (BETA1, _epoch, _labels, _Stepper, _train,  # noqa: F401
                                   collect, readings, window)
from benchmark.program_vit import build_model
from benchmark.reference import vit as ref
from benchmark.weights_vit import make_state


def _change(name: str, p: torch.Tensor, p0: torch.Tensor) -> float:
    """The norm of a leaf's change, a qkv bias's without its key third."""
    d = p - p0
    if name.endswith("attn.qkv.bias"):
        c = d.shape[0] // 3
        d = torch.cat([d[:c], d[2 * c:]])
    return float(d.norm())


def setup(cell):
    """As the ``train`` kind's set-up, with the ViT's model and weights."""
    from ssg_tpu_torch.train import schedule
    from ssg_tpu_torch.train import trainer as trainer_mod

    cfg, mix, dev = cell.config, cell.mix, cell.device
    gen = torch.Generator(device=dev).manual_seed(cell.sub("data"))
    n, ids = mix["images"], mix["identities"]
    assign = identities(gen, n, ids, mix["skew"], dev)
    labels = _labels(gen, assign, mix["part_noise"])
    pool = torch.empty((n, cfg["height"], cfg["width"], 3), dtype=torch.uint8)
    render_pool(gen, assign, ids, mix["cameras"], cfg["height"], cfg["width"], out=pool)
    pool = pool.numpy()
    lists = index_lists(labels[0])

    state = make_state(cfg, torch.Generator(device=dev).manual_seed(cell.sub("weights")))
    model = build_model(cfg, state, dev)
    opt = schedule.make_optimizer(model.parameters(), mix["lr"],
                                  weight_decay=mix["weight_decay"])
    step = trainer_mod.make_train_step(model, opt, margin=mix["margin"],
                                       num_parts=cfg["num_parts"], height=cfg["height"],
                                       width=cfg["width"])
    stepper = _Stepper(step, timed=dev.type == "cuda")
    trainer = trainer_mod.Trainer(stepper, opt, print_freq=mix["print_freq"], device=dev)
    crops = torch.Generator(device=dev).manual_seed(cell.sub("crops"))
    st = {"pool": pool, "labels": labels, "lists": lists, "model": model, "opt": opt,
          "trainer": trainer, "stepper": stepper, "crops": crops, "epoch": 0}

    # The checked steps: P x K batches whose rows all differ.
    rng = np.random.default_rng(cell.sub("check"))
    k, p = mix["instances"], mix["batch"] // mix["instances"]
    eligible = [lst for lst in lists if len(lst) >= k]
    picks = rng.choice(len(eligible), size=p * mix["check_steps"], replace=False)
    check = [np.concatenate([rng.choice(eligible[i], size=k, replace=False)
                             for i in picks[s * p:(s + 1) * p]])
             for s in range(mix["check_steps"])]
    first = []
    hook = model.register_forward_hook(
        lambda mod, args, out: first.append(out["embeddings"].detach().float().cpu()))
    _train(st, cell, check[:1])
    hook.remove()
    names = dict(model.named_parameters())
    g1 = {n: float(opt.state[q]["exp_avg"].norm()) / (1 - BETA1) if "exp_avg" in opt.state[q]
          else 0.0 for n, q in names.items()}
    _train(st, cell, check[1:])
    change = {n: _change(n, q.detach(), state[n]) for n, q in names.items()}
    del state
    st["check"] = {"losses": [float(x) for x in stepper.losses], "grad1": g1, "change": change,
                   "emb1": first[0],
                   "batches": [(torch.from_numpy(pool[b]), torch.from_numpy(labels[:, b]))
                               for b in check]}
    _train(st, cell, _epoch(st, cell)[:mix["warmup_steps"]])
    return st


def traced_slice(cell, st) -> dict:
    """One whole epoch, as the window runs them."""
    steps = _train(st, cell, _epoch(st, cell))["steps"]
    batch = cell.mix["batch"]
    return {"steps": steps, "flops": steps * train_step_flops(cell.config, batch),
            "attention_bound_s": steps * train_step_bound_s(cell.config, batch)}


def reference(cell, batches, quant=None) -> dict:
    """The reference's three steps from the seed's weights and crops, in
    fp32: losses, the first forward's embeddings, and each leaf's
    first-gradient and change norms."""
    dev, cfg, mix = cell.device, cell.config, cell.mix
    p0 = make_state(cfg, torch.Generator(device=dev).manual_seed(cell.sub("weights")))
    crops = torch.Generator(device=dev).manual_seed(cell.sub("crops"))
    feed = [(img.to(dev), lab.to(dev),
             torch.rand((5, lab.shape[-1]), generator=crops, device=dev))
            for img, lab in batches]
    with ref.fp32_mode():
        out = ref.train_steps(p0, cfg, feed, mix["lr"], mix["weight_decay"], mix["margin"],
                              quant=quant)
    return {"losses": out["losses"], "emb1": out["emb1"].cpu(),
            "grad1": {n: float(g.norm()) for n, g in out["grad1"].items()},
            "change": {n: _change(n, q, p0[n]) for n, q in out["params"].items()}}


def check(cell, out) -> tuple[dict, dict]:
    return readings(out, reference(cell, out["batches"])), {}


def control(cell, out) -> dict:
    """The reference in fp8 put in the program's place."""
    base = reference(cell, out["batches"])
    return readings(reference(cell, out["batches"], quant="fp8"), base)
