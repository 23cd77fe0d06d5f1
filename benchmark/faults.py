"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` catches them: each patches the program for the
``with`` block.

* ``unchanged``: the train step computes its loss and leaves the model and
  the optimizer's state as they were.
* ``half_batch``: the train step sees only the first half of each batch,
  the mean taken over it.
* ``alter``: one answer altered where it is produced: an extract's first
  embedding negated, or a clustering's first group with its largest
  cluster's points made noise (as a wrong border or core rule would).
"""

from __future__ import annotations

import contextlib

import numpy as np


class _NoStep:
    def __init__(self, opt):
        self.opt = opt
        self.param_groups = opt.param_groups

    def zero_grad(self, set_to_none: bool = True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        pass


@contextlib.contextmanager
def plant(name: str | None):
    if name is None:
        yield
        return
    from ssg_tpu_torch import api
    from ssg_tpu_torch.train import trainer

    saved = (trainer.make_train_step, api.extract_features, api.cluster_groups)
    make, extract, cluster = saved
    if name == "unchanged":
        def patched(model, optimizer, **kw):
            return make(model, _NoStep(optimizer), **kw)
        trainer.make_train_step = patched
    elif name == "half_batch":
        def patched(model, optimizer, **kw):
            step = make(model, optimizer, **kw)

            def half(images, labels, generator):
                b = labels.shape[-1] // 2
                return step(images[:b], labels[..., :b], generator)
            return half
        trainer.make_train_step = patched
    elif name == "alter":
        def extract_altered(*args, **kw):
            feats, *rest = extract(*args, **kw)
            feats = feats.clone()
            feats[0, 0] = -feats[0, 0]
            return (feats, *rest)

        def cluster_altered(*args, **kw):
            labels, counts, epss = cluster(*args, **kw)
            labels = labels.copy()
            ids, sizes = np.unique(labels[0][labels[0] >= 0], return_counts=True)
            labels[0][labels[0] == ids[np.argmax(sizes)]] = -1
            return labels, counts, epss
        api.extract_features, api.cluster_groups = extract_altered, cluster_altered
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        trainer.make_train_step, api.extract_features, api.cluster_groups = saved
