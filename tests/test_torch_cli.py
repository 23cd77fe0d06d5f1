"""The port's command-line entry points (``ssg_tpu_torch.cli``), its
checkpoint reader and its resnet18, on the CPU.

The CLIs are driven as ``tests/test_cli.py`` drives the root scripts:
tiny synthetic data, ``--arch resnet18`` at 64x32, fp32, plus ``--device
cpu``. Their parsers are held to the root scripts' options and defaults;
``load_torch_checkpoint`` and the resnet18 mapping to the JAX package's
(the root scripts and the JAX package are imported only here)."""

import argparse
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssg_tpu import models as jax_models
from ssg_tpu.models.convert import load_torch_checkpoint as jax_load_torch_checkpoint
from ssg_tpu.models.resnet import BasicBlock as JaxBasicBlock

from ssg_tpu_torch import models
from ssg_tpu_torch.cli import pretraining, selftraining, semitraining
from ssg_tpu_torch.models.convert import from_jax_variables, load_torch_checkpoint
from ssg_tpu_torch.utils import load_checkpoint
from test_torch_train import _two_pass_variance

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--scale", "tiny", "--batch_size", "16", "--num_instances", "2", "--arch", "resnet18",
         "--num_features", "16", "--height", "64", "--width", "32", "--dtype", "float32",
         "--device", "cpu"]
SSG = ["--src_dataset", "market1501", "--tgt_dataset", "dukemtmc", "--iteration", "1",
       "--epochs", "1", "--rho", "0.03", "--min_samples", "2", "--k1", "8", "--k2", "3"]


def _root_parsers() -> dict[str, argparse.ArgumentParser]:
    """The root scripts' parsers; ``semitraining``'s is built inside its
    ``main``, so it is caught there and ``--help`` stops the run."""
    sys.path.insert(0, str(REPO))
    import pretraining as root_pre
    import selftraining as root_self
    import semitraining as root_semi

    built = []

    def build():
        built.append(root_self.build_parser())
        return built[-1]

    with mock.patch.object(root_semi, "build_parser", build), pytest.raises(SystemExit), \
            mock.patch("sys.stdout"):
        root_semi.main(["--help"])
    return {"pretraining": root_pre.build_parser(), "selftraining": root_self.build_parser(),
            "semitraining": built[0]}


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: (a.default, a.type, a.choices, type(a).__name__, a.nargs)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name", ["pretraining", "selftraining", "semitraining"])
def test_parser_has_the_root_scripts_options_and_device(name):
    ours = _options({"pretraining": pretraining, "selftraining": selftraining,
                     "semitraining": semitraining}[name].build_parser())
    ref = _options(_root_parsers()[name])
    assert set(ours) - set(ref) == {"--device"}
    assert ours["--device"][0] == "cuda"
    assert {k: v for k, v in ours.items() if k != "--device"} == ref


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A softmax pretraining run (market1501: 15 identities) with an
    evaluation on dukemtmc, through the CLI."""
    logs = tmp_path_factory.mktemp("pre")
    stdout = sys.stdout
    assert pretraining.main(SMALL + ["--dataset", "market1501", "--epochs", "1",
                                     "--evaluate_on", "dukemtmc", "--logs_dir", str(logs)]) == 0
    assert sys.stdout is stdout  # restored, not left as the Logger
    return logs


def test_pretraining_cli_softmax_and_oim(pretrained, tmp_path):
    ckpt = load_checkpoint(str(pretrained / "source_checkpoint.pth"))
    assert ckpt["model"]["classifier_whole.weight"].shape == (15, 16)
    log = (pretrained / "log.txt").read_text()
    assert "source market1501: train=120 ids=15" in log and "Mean AP" in log
    assert '"kind": "seconds"' in (pretrained / "log.txt.jsonl").read_text()
    assert pretraining.main(SMALL + ["--epochs", "1", "--loss", "oim",
                                     "--logs_dir", str(tmp_path)]) == 0
    ckpt = load_checkpoint(str(tmp_path / "source_checkpoint.pth"))
    assert not any(k.startswith("classifier") for k in ckpt["model"])
    norms = ckpt["lut"].norm(dim=1)
    assert ckpt["lut"].shape == (15, 16) and bool((norms > 0).any())
    np.testing.assert_allclose(norms[norms > 0].numpy(), 1.0, rtol=1e-5)


def test_selftraining_cli_resumes_pretraining(pretrained, tmp_path):
    args = SMALL + SSG + ["--resume", str(pretrained / "source_checkpoint.pth")]
    # --resume loads the backbone and heads; the source classifier is left out.
    model = selftraining.load_model(selftraining.build_parser().parse_args(args))
    source = load_checkpoint(str(pretrained / "source_checkpoint.pth"))["model"]
    for key, value in model.state_dict().items():
        assert torch.equal(value, source[key]), key
    assert selftraining.main(args + ["--logs_dir", str(tmp_path), "--rerank"]) == 0
    assert (tmp_path / "checkpoint.pth").exists() and (tmp_path / "log.txt").exists()
    assert '"kind": "iteration"' in (tmp_path / "log.txt.jsonl").read_text()


def test_selftraining_cli_evaluate_short_circuit(tmp_path):
    assert selftraining.main(SMALL + SSG + ["--evaluate", "--logs_dir", str(tmp_path)]) == 0
    assert "Mean AP" in (tmp_path / "log.txt").read_text()
    assert not (tmp_path / "checkpoint.pth").exists()


def test_selftraining_cli_resume_loop(tmp_path):
    assert selftraining.main(SMALL + SSG + ["--logs_dir", str(tmp_path)]) == 0
    before = (tmp_path / "checkpoint.pth").stat().st_mtime_ns
    args = SMALL + SSG + ["--logs_dir", str(tmp_path), "--resume_loop",
                          str(tmp_path / "checkpoint.pth")]
    assert selftraining.main(args) == 0  # iteration 0 done: nothing left to run
    assert "continuing at iteration 1" in (tmp_path / "log.txt").read_text()
    assert (tmp_path / "checkpoint.pth").stat().st_mtime_ns == before


def test_semitraining_cli_resume_mismatched_heads(pretrained, tmp_path):
    """SSG++ from a source checkpoint: its classifier heads are sized to
    the 15 source identities, the target (dukemtmc) has 14, so the fresh
    target-sized heads are kept and everything else is resumed."""
    source = load_checkpoint(str(pretrained / "source_checkpoint.pth"))["model"]
    with mock.patch.object(semitraining, "run", return_value=0) as run:
        assert semitraining.main(SMALL + SSG + ["--resume", str(pretrained /
                                                                "source_checkpoint.pth"),
                                                "--logs_dir", str(tmp_path)]) == 0
    model = run.call_args.args[1]
    assert model.classifier_whole.weight.shape == (14, 16)
    for key, value in model.state_dict().items():
        if not key.startswith("classifier"):
            assert torch.equal(value, source[key]), key
    assert semitraining.main(SMALL + SSG + ["--ce_weight", "0.5", "--resume",
                                            str(pretrained / "source_checkpoint.pth"),
                                            "--logs_dir", str(tmp_path)]) == 0
    ckpt = load_checkpoint(str(tmp_path / "checkpoint.pth"))
    assert ckpt["model"]["classifier_up.weight"].shape == (14, 16)


@pytest.mark.parametrize("cli,flags,match", [
    (selftraining, ["--data_parallel"], None),
    (selftraining, ["--multihost"], "no coordinator"),
    (semitraining, ["--multihost", "--dist_coordinator", "localhost:1234"], "num_processes"),
])
def test_unported_flags_raise(tmp_path, cli, flags, match, monkeypatch):
    """The multi-GPU flags are ported: ``--data_parallel`` reaches the loop's
    config (a mesh of one without a process group; the loop over ranks is
    held to JAX in tests/test_torch_dp.py), and ``--multihost`` raises only
    for what its launch lacks: torchrun's environment, or the ``--dist_*``
    that go with a coordinator."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with mock.patch.object(cli, "run", return_value=0) as run:
        argv = SMALL + ["--logs_dir", str(tmp_path)] + flags
        if match is None:
            assert cli.main(argv) == 0
            assert selftraining.ssg_config(run.call_args.args[0]).data_parallel
        else:
            with pytest.raises(ValueError, match=match):
                cli.main(argv)
            run.assert_not_called()


def test_cuda_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        pretraining.main(["--logs_dir", str(tmp_path)])


# ---- resnet18 and checkpoints of other layouts ----------------------------------

def _jax_resnet18(rng, batch=4, stage_sizes=(2, 2, 2, 2)):
    fm = jax_models.SSGResNet(stage_sizes=stage_sizes, block=JaxBasicBlock, num_features=16,
                              num_parts=3, dtype=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    x = rng.normal(size=(batch, 64, 32, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v["batch_stats"])
    return fm, {"params": v["params"], "batch_stats": stats}, x


def test_resnet18_forward_and_mapping_match_jax(rng):
    assert jax_models.resnet18().stage_sizes == (2, 2, 2, 2)
    fm, variables, x = _jax_resnet18(rng)
    tm = models.create("resnet18", num_features=16)
    sd = from_jax_variables(variables)
    assert set(sd) == set(tm.state_dict())  # BasicBlock names map with no new rule
    assert "backbone.layer2.0.downsample.0.weight" in sd
    assert "backbone.layer1.0.downsample.0.weight" not in sd  # shapes equal: none
    tm.load_state_dict(sd)
    ours = tm.eval()(torch.from_numpy(x))["embeddings"].detach().numpy()
    ref = np.asarray(fm.apply(variables, jnp.asarray(x), train=False)["embeddings"])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # Train mode, as test_torch_train holds the bottleneck model: shallow
    # (one block a stage, the second with a downsample), BatchNorm over 16
    # images, within 2e-5 of JAX with Flax's two-pass variance.
    fm, variables, x = _jax_resnet18(rng, batch=16, stage_sizes=(1, 1))
    tm = models.create("resnet18", num_features=16, stage_sizes=(1, 1))
    tm.load_state_dict(from_jax_variables(variables))
    with _two_pass_variance():
        out, _ = fm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ours = tm.train()(torch.from_numpy(x))["embeddings"].detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(out["embeddings"]), rtol=0, atol=2e-5)


def test_load_torch_checkpoint_torchvision_layout(rng, tmp_path):
    """A torchvision-layout file (backbone keys without ``backbone.``, an
    ``fc`` classifier, DataParallel's ``module.``, the reference's
    ``{"state_dict", "epoch"}`` wrapper, no ``num_batches_tracked``):
    the port's embeddings within 1e-5 of JAX's reader and Flax forward."""
    fm, variables, x = _jax_resnet18(rng)
    full = from_jax_variables(variables)
    file_sd = {f"module.{k.removeprefix('backbone.')}": v for k, v in full.items()
               if k.startswith("backbone.") and not k.endswith("num_batches_tracked")}
    file_sd["module.fc.weight"] = torch.ones(1000, 512)
    file_sd["module.fc.bias"] = torch.ones(1000)
    path = tmp_path / "resnet18.pth.tar"
    torch.save({"state_dict": file_sd, "epoch": 3}, path)

    sd = load_torch_checkpoint(path)
    assert set(sd) == {k for k in full if k.startswith("backbone.")}
    heads = {k: v for k, v in full.items() if not k.startswith("backbone.")}
    tm = models.create("resnet18", num_features=16)
    tm.load_state_dict({**heads, **sd})
    ours = tm.eval()(torch.from_numpy(x))["embeddings"].detach().numpy()

    loaded = jax_load_torch_checkpoint(str(path))
    jv = {"params": {**variables["params"], "backbone": loaded["params"]["backbone"]},
          "batch_stats": {**variables["batch_stats"],
                          "backbone": loaded["batch_stats"]["backbone"]}}
    ref = np.asarray(fm.apply(jv, jnp.asarray(x), train=False)["embeddings"])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # A bare state_dict in the port's own layout reads as it is.
    torch.save(full, tmp_path / "bare.pth")
    back = load_torch_checkpoint(tmp_path / "bare.pth")
    assert set(back) == set(full) and all(torch.equal(back[k], full[k]) for k in full)
