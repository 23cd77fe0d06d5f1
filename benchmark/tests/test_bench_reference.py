"""Each plain reference against the program at tiny sizes on the CPU."""

from __future__ import annotations

import torch

from benchmark.frozen.features import clustered_features, identities
from benchmark.program import build_model
from benchmark.reference import cluster as rc
from benchmark.reference import resnet as rr
from benchmark.weights import make_state

TINY = {"stage_sizes": [1, 1, 1, 1], "last_stride": 2, "num_parts": 3, "num_features": 0,
        "height": 64, "width": 32, "dtype": "float32", "residual_bn_gamma": 0.1}


def test_train_transform():
    from ssg_tpu_torch.data import transforms

    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (6, 80, 40, 3), dtype=torch.uint8, generator=g)
    boxes, flips = transforms.draw_crops(torch.Generator().manual_seed(4), 6, 80, 40)
    u = torch.rand((5, 6), generator=torch.Generator().manual_seed(4))
    prog = transforms.normalize_float(transforms.crop_flip(images, boxes, flips, 64, 32),
                                      torch.float32)
    assert torch.allclose(rr.train_images(images, u, 64, 32), prog, atol=1e-4)


def test_eval_forward():
    state = make_state(TINY, torch.Generator().manual_seed(1))
    model = build_model(TINY, state, "cpu").eval()
    x = torch.randn(4, 64, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        prog = model(x)["embeddings"]
        ref = rr.forward(state, TINY, x, train=False)
    assert torch.allclose(prog, ref, atol=1e-5)


def test_train_step():
    from ssg_tpu_torch.train.schedule import make_optimizer
    from ssg_tpu_torch.train.trainer import make_train_step

    state = make_state(TINY, torch.Generator().manual_seed(1))
    model = build_model(TINY, state, "cpu")
    images = torch.randint(0, 256, (8, 64, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([[0, 0, 0, 0, 1, 1, 1, 1]] * 3)
    step = make_train_step(model, make_optimizer(model.parameters(), 6e-5), height=64,
                           width=32)
    loss = float(step(images, labels, torch.Generator().manual_seed(9))["loss"])
    u = torch.rand((5, 8), generator=torch.Generator().manual_seed(9))
    out = rr.train_steps(state, TINY, [(images, labels, u)], 6e-5, 5e-4, 0.3)
    assert abs(out["losses"][0] - loss) <= 1e-4 * abs(loss)
    med = float(torch.tensor([float(g.norm()) for g in out["grad1"].values()]).median())
    for name, p in model.named_parameters():
        g = out["grad1"][name]
        # Against the median leaf's norm where larger: the part BNs' bias
        # gradients are nought to rounding (the triplet loss is shift-free);
        # batch statistics over 8 images amplify fp32 round-off in the
        # backward pass to ~1e-2 of a leaf.
        assert float((p.grad - g).norm()) <= 3e-2 * max(float(g.norm()), med), name
        # Adam's first step moves each element by about lr, whatever the
        # gradient's size: a gradient at round-off may move either way.
        assert (p.detach() - out["params"][name]).abs().max() <= 2.5 * 6e-5, name


def test_cluster_group():
    from ssg_tpu_torch import api

    g = torch.Generator().manual_seed(3)
    assign = identities(g, 400, 30, 0.8, "cpu")
    feats = torch.stack([clustered_features(g, assign, 30, 48, 8) for _ in range(2)])
    labels, counts, epss = api.cluster_groups(feats, device="cpu")
    for grp in range(2):
        ref_labels, n, eps, cols = rc.cluster_group(feats[grp], 20, 6, 0.1, 1.6e-3, 4)
        assert (ref_labels == labels[grp]).all()
        assert n == counts[grp]
        assert abs(eps - epss[grp]) <= 1e-5 * eps
        assert int(cols.sum()) > 0


def test_label_gap():
    a = torch.tensor([0, 0, 1, 1, -1, 2]).numpy()
    assert rc.label_gap(a, a) == 0.0
    assert rc.label_gap(a, (a + 1) % 4) == 0.0  # a renumbering
    b = a.copy()
    b[0] = 1
    assert abs(rc.label_gap(a, b) - 1 / 6) < 1e-12
