"""The ViT's cell on the CPU: a tiny ``train_vit`` cell added from files
alone runs ``run.main`` to ``correct: true`` and to not correct under each
fault; the ViT's weights, operation counts and attention rule against the
program's shapes; the reference the same file as the port's."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import faults, run
from benchmark.frozen import traceview, vitflops, vitwork
from benchmark.harness import load_module
from benchmark.tests.tiny import BENCH, LIMITS, MIXES, ROOT, make_root
from benchmark.weights_vit import layout, make_state

VITB = json.loads((BENCH / "configs" / "ssg-vit-b16-s12.json").read_text())
TINY_VIT = {**VITB, "name": "tiny-vit", "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "head_dim": 16, "intermediate_size": 256,
            "patch_grid": [5, 2], "num_tokens": 11, "embedding_dim": 64, "height": 64,
            "width": 32, "dtype": "float32",
            "reduced": ["hidden_size", "num_hidden_layers", "num_attention_heads", "head_dim",
                        "intermediate_size", "height", "width", "dtype"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells' root with ``tiny-train-vit`` added as tiny.make_root
    adds its cells: a configuration, a traffic mix and limits as files, and
    entries in ``BENCHMARK.json``."""
    root = make_root(tmp_path_factory.mktemp("bench"))
    here = root / "benchmark"
    (here / "configs" / "tiny-vit.json").write_text(json.dumps(TINY_VIT))
    (here / "traffic" / "train-tiny-vit.json").write_text(
        json.dumps({**MIXES["train-tiny"], "kind": "train_vit"}))
    (here / "limits" / "tiny-train-vit.json").write_text(json.dumps(LIMITS["train"]))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-vit", "source": "a test's own", "reduced": [],
                             "why": "a test", "file": "benchmark/configs/tiny-vit.json"})
    bench["workloads"].append({"name": "tiny-train-vit", "config": "tiny-vit",
                               "traffic": "train-tiny-vit", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("train_"):
            m["workloads"].append("tiny-train-vit")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_tiny_vit_cell(root, fault, capsys):
    with faults.plant(fault):
        assert run.main(["--workload", "tiny-train-vit", "--seed", "2147483653",
                         "--seconds", "0.2"], device="cpu", root=root) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is (fault is None)
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap", "emb_gap", "failed"}
    assert {"train_img_per_s", "setup_s"} <= set(line["metrics"])


def test_weights_fit_the_program_at_published_widths():
    from ssg_tpu_torch.models.vit import SSGViT

    with torch.device("meta"):
        model = SSGViT(dtype=torch.bfloat16)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()
              if not n.endswith("num_batches_tracked")}
    assert shapes == {n: s for n, _, s in layout(VITB)}


def test_weights_are_seeded_and_initialised_as_vit():
    a = make_state(TINY_VIT, torch.Generator().manual_seed(5))
    b = make_state(TINY_VIT, torch.Generator().manual_seed(5))
    assert all(torch.equal(a[n], b[n]) for n in a)
    w = a["backbone.blocks.0.mlp.fc1.weight"]
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.02
    assert torch.equal(a["backbone.norm.weight"], torch.ones(64))
    assert float(a["backbone.blocks.1.attn.qkv.bias"].abs().max()) == 0.0


def test_flops_against_the_model_shapes():
    from ssg_tpu_torch.models.vit import SSGViT

    total = 0.0

    def hook(mod, args, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.weight[0].numel()

    cfg = {**TINY_VIT, "height": 112, "width": 64}
    model = SSGViT(img_size=(112, 64), embed_dim=64, depth=2, num_heads=4, mlp_dim=256)
    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()(torch.zeros(1, 112, 64, 3))
    t = model.backbone.num_tokens
    total += 2 * 2.0 * 2 * t * t * 64  # QK^T and PV, two layers
    assert vitflops.forward_flops(cfg) == pytest.approx(total, rel=1e-12)
    assert vitflops.forward_flops(VITB) / 1e9 == pytest.approx(37.731, abs=5e-4)
    assert vitflops.train_step_flops(VITB, 64) / 1e12 == pytest.approx(7.2444, abs=5e-5)
    assert vitwork.attention_flops(VITB, 64) == 4.0 * 64 * 12 * 211 * 211 * 768


def test_attention_rule_and_readers():
    names = {"void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>": 30,
             "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<>": 60,
             "fmha_cutlassF_bf16_aligned_64x64_rf_sm80": 10,
             "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": 90,
             "void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>": 10}
    events = []
    ts = 0
    for name, dur in names.items():
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur})
        ts += dur
    info = {"trace": traceview.reduce_slice(events, 400e-6),
            "counts": {"attention_bound_s": 50e-6}}
    read = {m: load_module(ROOT / "benchmark" / "metrics" / f"{m}.py",
                           "reader_" + m.replace(".", "_")).read
            for m in ("attention_pct.train", "attention_roofline.train")}
    assert read["attention_pct.train"](info) == pytest.approx(100.0 * 100 / 200, rel=1e-12)
    assert read["attention_roofline.train"](info) == pytest.approx(50.0, rel=1e-12)
    none = {"trace": traceview.reduce_slice(events[3:], 100e-6), "counts": {}}
    assert read["attention_pct.train"](none) is None
    assert read["attention_roofline.train"](none) is None
    bound = vitwork.train_step_bound_s(VITB, 64)  # bytes bound each pass at T = 211, d = 64
    per = 64 * 211 * 768 * 2
    lse = 4.0 * 64 * 12 * 211
    assert bound == pytest.approx(12 * (4 * per + 8 * per + 2 * lse) / 3.35e12, rel=1e-12)


def test_reference_is_the_ports():
    port = ROOT / "ssg_tpu_torch" / "reference" / "vit.py"
    assert (BENCH / "reference" / "vit.py").read_bytes() == Path(port).read_bytes()
