"""The SSG ViT on a card: its graphed train step and graphed extract
against their eager twins, and the attention route it restricts itself to. Every test needs a CUDA
device and skips without one. This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_vit_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ssg_tpu_torch import api, models, resolve_device
from ssg_tpu_torch.train.schedule import make_optimizer
from ssg_tpu_torch.train.trainer import make_train_step
from ssg_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# Two heads of 64 at 256x128: ViT-B's head size and 211 tokens, at a width
# and depth that build in seconds.
SMALL = dict(embed_dim=128, depth=2, num_heads=2, mlp_dim=512, num_features=16, num_classes=4,
             dtype=torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and the flash route exist only there)")
    return resolve_device("cuda")


def _batches(cuda, steps):
    gen = torch.Generator().manual_seed(0)
    labels = torch.tensor([[0, 0, 1, 1, 2, 2, 3, 3]] * 3 + [[0, 0, 1, 1, -1, -1, 3, 3]])
    return [(torch.randint(0, 256, (8, 256, 128, 3), generator=gen, dtype=torch.uint8).to(cuda),
             labels.to(cuda)) for _ in range(steps)]


def test_graphed_step_equals_eager_step(cuda, monkeypatch):
    # The same weights, crops and batches through two steps: the first
    # graphed from its second call on, the second kept eager by a forward
    # pre-hook that does nothing. Bit for bit: a replay runs the eager
    # step's kernels on the same inputs (FlashAttention's backward adds two
    # key blocks' dQ at 211 tokens, in either order the same sum).
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    base = models.create("vit_base_patch16_s12", **SMALL)
    base.reset_parameters(torch.Generator().manual_seed(0))
    runs = []
    for graphed in (True, False):
        model = models.create("vit_base_patch16_s12", **SMALL)
        model.load_state_dict(base.state_dict())
        model.to(cuda, memory_format=torch.channels_last)
        if not graphed:
            model.register_forward_pre_hook(lambda mod, args: None)
        opt = make_optimizer(model.parameters(), 1e-3)
        step = make_train_step(model, opt, num_parts=3, height=256, width=128, ce_weight=0.5)
        crops = torch.Generator(device=cuda).manual_seed(1)
        with profiling.record_spans():
            outs = [step(x, y, crops) for x, y in _batches(cuda, 4)]
            torch.cuda.synchronize()
        rec = profiling.recorded()
        runs.append((model, opt, outs, rec.counters))
    (mg, og, outs_g, counters_g), (me, oe, outs_e, counters_e) = runs
    assert counters_g == {"train.graph_replays": 3, "vit.attention.flash": 2}
    assert counters_e == {"vit.attention.flash": 4}
    for key in ("loss", "prec"):
        got = torch.stack([o[key] for o in outs_g])
        want = torch.stack([o[key] for o in outs_e])
        assert torch.equal(got, want), (key, got, want)
    for (name, p), q in zip(mg.named_parameters(), me.parameters()):
        assert torch.equal(p, q), name
        for k, v in og.state[p].items():  # the AdamW moments and step count
            assert torch.equal(v, oe.state[q][k]), (name, k)
    for (name, t), u in zip(mg.named_buffers(), me.buffers()):
        assert torch.equal(t, u), name


def test_graphed_extract_equals_eager_extract(cuda, monkeypatch):
    # Two calls over three batches on the same weights: the graphed model
    # runs its first batch eager and replays the rest (2, then 3), the eager
    # twin (a forward pre-hook that does nothing) replays none; bit for bit
    # the same features.
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    base = models.create("vit_base_patch16_s12", **SMALL)
    base.reset_parameters(torch.Generator().manual_seed(0))
    meta = np.zeros(8)
    feed = [(x, meta, meta, np.ones(8, dtype=bool)) for x, _ in _batches(cuda, 3)]
    runs = []
    for graphed in (True, False):
        model = models.create("vit_base_patch16_s12", **SMALL)
        model.load_state_dict(base.state_dict())
        model.to(cuda, memory_format=torch.channels_last)
        if not graphed:
            model.register_forward_pre_hook(lambda mod, args: None)
        for _ in range(2):
            with profiling.record_spans():
                feats = api.extract_features(model, feed, device=cuda)[0]
                torch.cuda.synchronize()
            runs.append((feats, profiling.recorded().counters.get(api.EXTRACT_GRAPH_REPLAYS, 0)))
    assert [n for _, n in runs] == [2, 3, 0, 0]
    for got, want in zip(runs[:2], runs[2:]):
        assert torch.equal(got[0], want[0]), float((got[0] - want[0]).abs().max())


def test_attention_takes_the_flash_route_at_211_tokens(cuda):
    # ViT-B's attention shape in bf16: the route runs forward and backward
    # (it raises where it cannot), its kernels are FlashAttention's, and it
    # agrees with the math route in fp32 to bf16's rounding.
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((4, 12, 211, 64), generator=gen, device=cuda)
               for _ in range(3))
    with sdpa_kernel(SDPBackend.MATH):
        want = F.scaled_dot_product_attention(q, k, v)
    qb, kb, vb = (t.bfloat16().requires_grad_() for t in (q, k, v))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            got = F.scaled_dot_product_attention(qb, kb, vb)
        got.float().square().sum().backward()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("flash_fwd" in n for n in names) and any("flash_bwd" in n for n in names), names
    assert float((got.detach().float() - want).abs().max()) < 2e-2  # bf16 inputs and output
    model = models.create("vit_base_patch16_s12", **SMALL).to(cuda)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with profiling.record_spans(), torch.no_grad():
        model.eval()(torch.zeros((2, 256, 128, 3), device=cuda))
    assert profiling.recorded().counters == {"vit.attention.flash": 1}
