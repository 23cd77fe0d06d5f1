"""SSG fine-tuning: P x K batches through ``Trainer.train`` and
``make_train_step``, the way ``run_ssg`` fine-tunes.

Set-up renders the mix's pool of uint8 images on the card from the seed and
copies it to host memory once; draws the identities (log-normal skew) and
three pseudo-label rows (row 0 the identities, each part row with a share
of its entries noise, -1); builds the configuration's model with the
benchmark's weights, the program's AdamW and train step, and a
``Trainer``. Batches are drawn by the frozen P x K sampler and gathered on
the host, so the window covers the trainer's pinning, prefetch and upload
as well as the step. The first ``check_steps`` (three) batches, of rows
that all differ, go through the same ``Trainer.train`` call in set-up; the
first gradient (from AdamW's first moment after one step) and each
parameter's change after three are kept, and the plain reference follows
the same three steps after the window. The window runs whole epochs (one
``Trainer.train`` call each) until ``--seconds`` have passed.

Metrics: ``train_img_per_s``, images stepped over the window, which ends
in a synchronise; ``train_step_p95_ms``, the 95th percentile over the
window's steps of the stream time between consecutive step boundaries
(a CUDA event recorded after each step, no synchronise per step).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.frozen.features import identities
from benchmark.frozen.flops import train_step_flops
from benchmark.frozen.render import render_pool
from benchmark.frozen.sampler import epoch_batches, index_lists
from benchmark.program import build_model
from benchmark.reference import resnet as ref
from benchmark.weights import make_state

BETA1 = 0.9


class _Stepper:
    """The program's step, with a CUDA event after each call (the step
    boundary) and its loss kept."""

    def __init__(self, step, timed: bool):
        self.step, self.timed = step, timed
        self.events, self.losses = [], []

    def __call__(self, images, labels, generator):
        out = self.step(images, labels, generator)
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.losses.append(out["loss"])
        return out


def _labels(gen, assign: torch.Tensor, noise: list[float]) -> np.ndarray:
    rows = []
    for frac in noise:
        row = assign.clone()
        if frac > 0:
            drop = torch.rand(assign.shape, generator=gen, device=assign.device) < frac
            row[drop] = -1
        rows.append(row)
    return torch.stack(rows).cpu().numpy().astype(np.int64)


def setup(cell):
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
    change = {n: float((q.detach() - state[n]).norm()) for n, q in names.items()}
    del state
    st["check"] = {"losses": [float(x) for x in stepper.losses], "grad1": g1, "change": change,
                   "emb1": first[0],
                   "batches": [(torch.from_numpy(pool[b]), torch.from_numpy(labels[:, b]))
                               for b in check]}
    _train(st, cell, _epoch(st, cell)[:mix["warmup_steps"]])
    return st


def _epoch(st, cell):
    st["epoch"] += 1
    return epoch_batches(st["lists"], cell.mix["instances"], cell.mix["batch"],
                         cell.sub(f"epoch{st['epoch']}"))


def _train(st, cell, batches):
    pool, labels = st["pool"], st["labels"]

    def feed():
        for idx in batches:
            yield pool[idx], labels[:, idx]

    return st["trainer"].train(st["epoch"], feed(), st["crops"], lr=cell.mix["lr"],
                               prefetch_depth=cell.mix["prefetch_depth"])


def window(cell, st, seconds: float) -> dict:
    on_card = cell.device.type == "cuda"
    stepper = st["stepper"]
    stepper.losses = []
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        stepper.events = [start]
    t0 = time.perf_counter()
    steps, units = 0, []
    while True:
        steps += _train(st, cell, _epoch(st, cell))["steps"]
        units.append(time.perf_counter() - t0 - sum(units))
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    losses = torch.stack(stepper.losses)
    failed = int((~torch.isfinite(losses)).sum())
    metrics = {"train_img_per_s": steps * cell.mix["batch"] / elapsed}
    if on_card:
        ev = stepper.events
        ms = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
        metrics["train_step_p95_ms"] = float(np.percentile(ms, 95))
        stepper.events = []
    return {"metrics": metrics, "attempted": steps, "failed": failed, "units": units}


def traced_slice(cell, st) -> dict:
    """One whole epoch, as the window runs them."""
    steps = _train(st, cell, _epoch(st, cell))["steps"]
    return {"steps": steps, "flops": steps * train_step_flops(cell.config, cell.mix["batch"])}


def collect(cell, st) -> dict:
    return st["check"]


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
            "change": {n: float((q - p0[n]).norm()) for n, q in out["params"].items()}}


def readings(prog: dict, ref_: dict) -> dict:
    """The numbers compared: each step's loss (``loss_gap``, the worst
    relative gap), the first gradient's and the change's leaf norms
    (``grad_gap``, ``change_gap``: the worst gap of norms against the
    larger of the leaf's and the median leaf's reference norm), and the
    first forward's train-mode embeddings (``emb_gap``: the worst row's
    distance relative to the reference row's norm; a missing row reads
    infinite). Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone under Adam and are left out of
    the change."""
    def worst(values):  # NaN anywhere reads NaN, and fails
        return float(np.max(np.asarray(list(values), dtype=np.float64), initial=-np.inf)
                     if values else np.nan)

    loss = worst([abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_["losses"])])
    g_ref = ref_["grad1"]
    g_med = float(np.median(list(g_ref.values())))
    grad = worst([abs(prog["grad1"][n] - g) / max(g, g_med) for n, g in g_ref.items()])
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref_["change"]
    c_med = float(np.median([c_ref[n] for n in moved])) if moved else np.nan
    change = worst([abs(prog["change"][n] - c_ref[n]) / max(c_ref[n], c_med) for n in moved])
    e_p, e_r = prog["emb1"], ref_["emb1"]
    emb = (float(((e_p - e_r).norm(dim=2) / e_r.norm(dim=2)).max())
           if e_p.shape == e_r.shape else np.inf)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "emb_gap": emb}


def check(cell, out) -> tuple[dict, dict]:
    return readings(out, reference(cell, out["batches"])), {}


def control(cell, out) -> dict:
    """The reference in fp8 put in the program's place."""
    base = reference(cell, out["batches"])
    return readings(reference(cell, out["batches"], quant="fp8"), base)

