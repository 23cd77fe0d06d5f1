"""The SSG ViT (``models.vit``) against its plain fp32 reference
(``ssg_tpu_torch.reference.vit``) on seeded random weights, on the CPU, and
the split of ``SSGHeads`` into pooling and projection.

A tiny ViT (depth 2, width 64, 4 heads, MLP 256, 64x32 images at patch 16 /
stride 12, so 5 x 2 patches and 11 tokens) runs in fp32 through the same
code as ViT-B/16. The port and the reference compute the same function in
fp32 with sums in another order (the attention's scaling, LayerNorm's
statistics, the GEMMs' blocking), so embeddings agree to about 1e-6 of
their size and gradients to about 5e-6 of the largest leaf's: the
tolerances below are 1e-5 relative for that reason, and wider only where a
comment gives the reason.
"""

import copy

import numpy as np
import pytest
import torch

from ssg_tpu_torch import api, models
from ssg_tpu_torch.cli import selftraining
from ssg_tpu_torch.models.vit import SSGViT, attention_route, vit_base_patch16_s12
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss
from ssg_tpu_torch.reference import vit as ref
from ssg_tpu_torch.train.schedule import make_optimizer
from ssg_tpu_torch.train.trainer import Trainer, make_train_step
from ssg_tpu_torch.utils import profiling

TINY = dict(img_size=(64, 32), embed_dim=64, depth=2, num_heads=4, mlp_dim=256)
CONFIG = dict(patch_size=16, patch_stride=12, num_hidden_layers=2, num_attention_heads=4,
              layer_norm_eps=1e-6, num_parts=3, num_features=0, height=64, width=32)
LABELS = torch.tensor([[0, 0, 1, 1, 2, 2, 3, 3],
                       [0, 0, 1, 1, -1, 2, 3, 3],
                       [0, 0, -1, 1, 2, 2, 3, 3]])


def _tiny(seed=1, **kw):
    """The tiny ViT with every parameter drawn at random (not ViT's
    initialisation: LayerNorm and BatchNorm affine terms away from the
    identity, so each reaches the output)."""
    model = models.create("vit_base_patch16_s12", **{**TINY, **kw})
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.3 if p.dim() > 1 else 0.5))
            if name.endswith(("norm1.weight", "norm2.weight", "norm.weight")) or "feat_bn" in name:
                p.add_(1.0)
    return model


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _images(seed, batch=8, h=64, w=32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (batch, h, w, 3), generator=gen, dtype=torch.uint8)


def _close(got, want, what, rel=1e-5):
    # 1e-5 of the reference's largest entry: fp32 sums in another order.
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rel, atol=rel * scale, msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_embeddings_match_reference(train):
    model = _tiny().train(train)
    x = ref.normalize(_images(0).float())
    with torch.no_grad():
        got = model(x)["embeddings"]
        want = ref.forward(_state(model), CONFIG, x, train)
    assert got.shape == (3, 8, 64)
    _close(got, want, "embeddings")


def test_gradients_match_reference():
    model = _tiny().train()
    x = ref.normalize(_images(0).float())
    emb = model(x)["embeddings"]
    loss = sum(batch_hard_triplet_loss(emb[g], LABELS[g], 0.3)[0] for g in range(3))
    loss.backward()
    params = {k: v.requires_grad_(v.is_floating_point()) for k, v in _state(model).items()}
    emb_r = ref.forward(params, CONFIG, x, True)
    loss_r = sum(ref.triplet(emb_r[g], LABELS[g], 0.3) for g in range(3))
    assert float(loss.detach()) == pytest.approx(float(loss_r.detach()), rel=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_r, [params[n] for n in names])
    # 1e-5 of the largest leaf's gradient: a leaf that the batch BatchNorm
    # makes invariant (a bias before it) has a reference gradient of pure
    # round-off, which no relative test can hold.
    scale = max(float(g.abs().max()) for g in grads)
    for (name, p), g in zip(model.named_parameters(), grads):
        torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-5 * scale, msg=name)


def _change_norms(params: dict, p0: dict, grad1: dict) -> dict[str, float]:
    """Each moved leaf's change norm. Adam moves a leaf whose gradient is
    round-off (1e-8 where others read 1) by a step of its own sign, so
    leaves under 1e-3 of the median leaf's gradient norm are left out (the
    benchmark's rule), and so is the key third of each qkv bias: adding a
    constant to every key shifts a query's logits alike, which the softmax
    ignores, so its gradient is round-off too."""
    norms = {n: float(g.norm()) for n, g in grad1.items()}
    med = float(np.median(list(norms.values())))
    out = {}
    for name in (n for n, v in norms.items() if v >= 1e-3 * med):
        d = params[name].detach() - p0[name]
        if name.endswith("attn.qkv.bias"):
            c = d.shape[0] // 3
            d = torch.cat([d[:c], d[2 * c:]])
        out[name] = float(d.norm())
    return out


@pytest.mark.parametrize("path", ["step", "trainer"])
def test_three_train_steps_match_reference_adamw(path):
    model = _tiny()
    p0 = _state(model)
    lr, wd = 1e-3, 5e-4
    opt = make_optimizer(model.parameters(), lr, weight_decay=wd)
    step = make_train_step(model, opt, margin=0.3, num_parts=3, height=64, width=32)
    batches = [(_images(s), LABELS) for s in range(3)]
    if path == "step":
        crops = torch.Generator().manual_seed(7)
        losses = [float(step(x, y, crops)["loss"]) for x, y in batches]
    else:
        got = []

        def recording(images, labels, generator):
            out = step(images, labels, generator)
            got.append(float(out["loss"]))
            return out

        trainer = Trainer(recording, opt, print_freq=10, device="cpu")
        feed = [(x.numpy(), y.numpy()) for x, y in batches]
        trainer.train(0, feed, torch.Generator().manual_seed(7), prefetch_depth=0)
        losses = got
    draws = torch.Generator().manual_seed(7)  # the step's crops, drawn in the same order
    feed = [(x, y, torch.rand((5, 8), generator=draws)) for x, y in batches]
    out = ref.train_steps(p0, CONFIG, feed, lr, wd, 0.3)
    np.testing.assert_allclose(losses, out["losses"], rtol=1e-5)
    got = _change_norms(dict(model.named_parameters()), p0, out["grad1"])
    want = _change_norms(out["params"], p0, out["grad1"])
    # 1e-3: Adam divides each element's gradient gap by the root of its
    # second moment, so small elements carry their relative gap into the step.
    for name, w in want.items():
        assert got[name] == pytest.approx(w, rel=1e-3), name


def test_extract_features_matches_reference():
    # At 256x128 (21 x 10 patches, 211 tokens): the extract resizes every
    # image to it.
    model = _tiny(img_size=(256, 128))
    images = _images(3, batch=6, h=256, w=128).numpy()
    batches = [(images[:4], np.arange(4), np.zeros(4), np.ones(4, dtype=bool)),
               (images[4:], np.arange(2), np.zeros(2), np.array([True, False]))]
    feats, pids, _, _ = api.extract_features(model, batches, device="cpu")
    assert model.training  # the mode is restored
    config = dict(CONFIG, height=256, width=128)
    want = ref.forward(_state(model), config, ref.normalize(torch.from_numpy(images[:5]).float()),
                       train=False)
    assert feats.shape == (3, 5, 64) and list(pids) == [0, 1, 2, 3, 0]
    _close(feats, want, "extract")


def test_factory_builds_the_published_widths():
    with torch.device("meta"):  # no weights drawn: counted, not run
        model = models.create("vit_base_patch16_s12", num_features=0, num_parts=3,
                              dtype=torch.bfloat16, last_stride=1)
    vit = model.backbone
    assert isinstance(model, SSGViT) and "vit_base_patch16_s12" in models.names()
    conv = vit.patch_embed.proj
    assert (conv.kernel_size, conv.stride, conv.padding) == ((16, 16), (12, 12), (0, 0))
    assert vit.grid == (21, 10) and vit.num_tokens == 211
    assert vit.pos_embed.shape == (1, 211, 768) and vit.cls_token.shape == (1, 1, 768)
    assert len(vit.blocks) == 12 and vit.norm.eps == 1e-6
    blk = vit.blocks[0]
    assert blk.attn.num_heads == 12 and blk.attn.qkv.weight.shape == (2304, 768)
    assert blk.attn.qkv.bias is not None and blk.mlp.fc1.weight.shape == (3072, 768)
    assert blk.norm1.eps == 1e-6 and blk.dtype == torch.bfloat16
    assert sum(p.numel() for p in vit.parameters()) == 85_809_408
    assert all(p.dtype == torch.float32 for p in model.parameters())  # fp32 masters
    assert model.embedding_dim == 768 and model.num_parts == 3
    names = {n for n, _ in model.named_parameters()}
    for name in ("backbone.patch_embed.proj.weight", "backbone.cls_token", "backbone.pos_embed",
                 "backbone.blocks.11.attn.proj.bias", "backbone.blocks.0.mlp.fc2.weight",
                 "backbone.norm.bias", "feat_bn_down.weight"):
        assert name in names, name


def test_reset_parameters_is_vits_initialisation():
    a = vit_base_patch16_s12(**TINY).reset_parameters(torch.Generator().manual_seed(0))
    b = vit_base_patch16_s12(**TINY).reset_parameters(torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    qkv = a.backbone.blocks[0].attn.qkv
    w = qkv.weight.detach()
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.02
    assert float(qkv.bias.detach().abs().max()) == 0.0
    assert float(a.backbone.pos_embed.detach().abs().max()) <= 0.04
    assert torch.equal(a.backbone.norm.weight, torch.ones(64))


def test_bf16_model_computes_bf16_on_an_fp32_stream():
    model = _tiny(dtype=torch.bfloat16)
    seen = {}
    for name in ("patch_embed.proj", "blocks.0.attn.qkv", "blocks.0.mlp.fc2", "blocks.0.norm1"):
        model.backbone.get_submodule(name).register_forward_hook(
            lambda mod, args, out, name=name: seen.__setitem__(name, (args[0].dtype, out.dtype)))
    out = model(ref.normalize(_images(0).float()))["embeddings"]
    assert seen["patch_embed.proj"] == (torch.bfloat16, torch.bfloat16)
    assert seen["blocks.0.attn.qkv"] == (torch.bfloat16, torch.bfloat16)
    assert seen["blocks.0.mlp.fc2"] == (torch.bfloat16, torch.bfloat16)
    assert seen["blocks.0.norm1"] == (torch.float32, torch.float32)  # the residual stream
    assert out.dtype == torch.float32  # the heads
    want = ref.forward(_state(model), CONFIG, ref.normalize(_images(0).float()), True)
    # bf16 rounding, not another model:
    assert float((out.detach() - want).norm() / want.norm()) < 0.05


def test_eval_casts_are_cached_until_the_master_changes():
    model = _tiny(dtype=torch.bfloat16).eval()
    fc = model.backbone.blocks[0].mlp.fc1
    with torch.no_grad():
        model(ref.normalize(_images(0).float()))
        first = fc._cast_cache[1]
        model(ref.normalize(_images(1).float()))
        assert fc._cast_cache[1] is first
        fc.weight.add_(1.0)
        model(ref.normalize(_images(1).float()))
    assert fc._cast_cache[1] is not first
    assert torch.equal(fc._cast_cache[1], fc.weight.detach().to(torch.bfloat16))


def test_remat_leaves_loss_and_gradients_unchanged():
    plain = _tiny()
    remat = copy.deepcopy(plain)
    x = ref.normalize(_images(0).float())
    for model, flag in ((plain, False), (remat, True)):
        emb = model(x, remat=flag)["embeddings"]
        sum(batch_hard_triplet_loss(emb[g], LABELS[g], 0.3)[0] for g in range(3)).backward()
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), name


def test_spans_and_attention_counter():
    model = _tiny()
    with profiling.record_spans():
        with torch.no_grad():
            model(ref.normalize(_images(0).float()))
    rec = profiling.recorded()
    assert [s.key for s in rec.of("vit.block")] == [0, 1]
    assert len(rec.of("vit.embed")) == len(rec.of("vit.heads")) == 1
    assert rec.counters == {"vit.attention.math": 1}
    assert attention_route(torch.device("cuda"), torch.bfloat16) == "flash"
    assert attention_route(torch.device("cuda"), torch.float32) == "math"
    assert attention_route(torch.device("cpu"), torch.bfloat16) == "math"


def test_an_image_of_another_size_is_refused():
    with pytest.raises(ValueError, match="position table"):
        _tiny()(torch.zeros((2, 80, 32, 3)))


def test_selftraining_cli_runs_the_vit(tmp_path, monkeypatch):
    # The factory name through the CLI, the loop's extract, clustering and
    # fine-tuning, at toy scale: the name's constructor with tiny widths, at
    # the 256x128 the extract resizes to.
    monkeypatch.setitem(models._FACTORY, "vit_base_patch16_s12",
                        lambda **kw: vit_base_patch16_s12(**{**kw, **TINY,
                                                             "img_size": (256, 128)}))
    args = ["--scale", "tiny", "--batch_size", "16", "--num_instances", "2",
            "--arch", "vit_base_patch16_s12", "--height", "256", "--width", "128",
            "--dtype", "float32", "--device", "cpu", "--src_dataset", "market1501",
            "--tgt_dataset", "dukemtmc", "--iteration", "1", "--epochs", "1", "--rho", "0.03",
            "--min_samples", "2", "--k1", "8", "--k2", "3", "--logs_dir", str(tmp_path)]
    assert selftraining.main(args) == 0
    assert isinstance(selftraining.load_model(selftraining.build_parser().parse_args(args)),
                      SSGViT)
    assert '"kind": "iteration"' in (tmp_path / "log.txt.jsonl").read_text()


# ---- the SSGHeads split: ResNet and Inception outputs as before ------------------------

def _heads_before_split(model, fmap):
    # SSGHeads._heads as it was before pooling and projection were split.
    h = fmap.shape[2]
    pools = [fmap.mean((2, 3)), fmap[:, :, :max(h // 2, 1)].mean((2, 3)),
             fmap[:, :, h // 2:].mean((2, 3))][:model.num_parts]
    embeddings, logits = [], []
    head_dtype = torch.promote_types(model.dtype, torch.float32)
    for part, pooled in zip(("whole", "up", "down"), pools):
        y = pooled.to(head_dtype)
        if model.num_features > 0:
            y = getattr(model, f"feat_{part}")(y)
        y = getattr(model, f"feat_bn_{part}")(y)
        emb = y
        if not model.training and model.norm:
            emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
        if model.num_classes > 0:
            logits.append(getattr(model, f"classifier_{part}")(model.drop(y)))
        embeddings.append(emb)
    out = {"embeddings": torch.stack(embeddings)}
    if logits:
        out["logits"] = torch.stack(logits)
    return out


@pytest.mark.parametrize("arch", ["resnet50", "inception"])
@pytest.mark.parametrize("train", [True, False])
def test_heads_split_leaves_cnn_outputs_bit_identical(arch, train):
    kw = dict(stage_sizes=(1, 1)) if arch == "resnet50" else dict(depth=3, width=16)
    model = models.create(arch, num_features=16, num_classes=5, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0)).train(train)
    x = torch.randn((4, 64, 32, 3), generator=torch.Generator().manual_seed(1))
    fmaps = []
    hook = model._heads  # the backbone's map, as the heads receive it
    model._heads = lambda fmap: (fmaps.append(fmap), hook(fmap))[1]
    before = copy.deepcopy(model)  # BatchNorm statistics as they are now
    with torch.no_grad():
        got = model(x)
        want = _heads_before_split(before, fmaps[0])
    assert got.keys() == want.keys() == {"embeddings", "logits"}
    for key in got:
        assert torch.equal(got[key], want[key]), key
