"""The port's SSG Inception against the JAX package's ``SSGInception``, on
the CPU: the eval and train-mode forwards and BatchNorm statistics, the
default depth 8 / width 64 at 256x128 (1024-d embeddings), the weight
mapping, and ``--arch inception`` through the CLIs. remat is held to the
plain step in ``test_torch_pretrain.py::test_remat_step_equals_plain_step``.

Both packages hold the same weights through ``from_jax_variables``; fp32,
JAX at its default CPU precision (fp32 convolutions)."""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ssg_tpu.models.inception import SSGInception as JaxSSGInception

from ssg_tpu_torch import models
from ssg_tpu_torch.cli import pretraining, selftraining
from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.utils import load_checkpoint
from test_torch_train import _two_pass_variance


def _pair(rng, x, **kw):
    """A JAX ``SSGInception`` with non-trivial BN statistics and scales,
    and the port's model holding the same weights (strict load)."""
    fm = JaxSSGInception(dtype=jnp.float32, **kw)
    init = jax.jit(lambda key, x: fm.init(key, x, train=False))  # eager init takes ~10 s
    v = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key == "scale" else a), v["params"])
    variables = {"params": params, "batch_stats": stats}
    tm = models.create("inception", **kw)
    tm.load_state_dict(from_jax_variables(variables))  # strict: no missing or unexpected keys
    return fm, variables, tm


def _eval(fm):
    return jax.jit(lambda v, x: fm.apply(v, x, train=False))


def test_inception_forward_and_bn_statistics_match_jax(rng):
    """depth 3 / width 16 (both downsampling blocks), 64x32, 16 images,
    num_features 16. Eval within 1e-5 (unit-norm embeddings). The
    train-mode embeddings are raw BatchNorm outputs (here up to ~2.5), and
    train-mode BN over 16 images amplifies fp32 rounding, so they are held
    relative to their largest entry: within 1e-5 of it from the same
    forward in fp64, and within 2e-5 of it from JAX with Flax's two-pass
    variance (each side's own error added, as the ResNet's train-mode test
    holds it in absolute terms). Every BN's running statistics after the
    step within 1e-6 of JAX's."""
    x = rng.normal(size=(16, 64, 32, 3)).astype(np.float32)
    fm, variables, tm = _pair(rng, x, depth=3, width=16, num_features=16)
    want = np.asarray(_eval(fm)(variables, jnp.asarray(x))["embeddings"])
    got = tm.eval()(torch.from_numpy(x))["embeddings"].detach().numpy()
    assert got.shape == (3, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    exact = copy.deepcopy(tm).double()
    exact.dtype = torch.float64
    with torch.no_grad():
        want64 = exact.train()(torch.from_numpy(x).double())["embeddings"].numpy()
    with _two_pass_variance():
        out, upd = jax.jit(lambda v, x: fm.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    ours = tm.train()(torch.from_numpy(x))["embeddings"].detach().numpy()
    scale = float(np.abs(want64).max())
    np.testing.assert_allclose(ours, want64, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(ours, np.asarray(out["embeddings"]), rtol=0, atol=2e-5 * scale)
    ref = from_jax_variables({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    state = tm.state_dict()
    assert {k for k in state if "running" in k} == set(
        k for k in ref if "running" in k)
    for key, value in ref.items():
        if "running" in key:
            atol = 1e-6 * float(value.abs().max())
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=1e-6, atol=atol,
                                       err_msg=key)


def test_inception_default_width_matches_jax(rng):
    """The default depth 8 / width 64 on 2 images of 256x128: the block
    widths run 64 -> 256 -> 512 -> 1024 (a stride-2 block's max-pool
    branch passes its input through), so the embeddings are 1024-d, within
    1e-5 of JAX's in fp32 eval mode."""
    x = rng.normal(size=(2, 256, 128, 3)).astype(np.float32)
    fm, variables, tm = _pair(rng, x, num_features=0)
    assert [getattr(tm, f"block{i}").out_channels for i in range(8)] == [
        256, 256, 512, 512, 512, 1024, 1024, 1024]
    assert tm.embedding_dim == 1024
    want = np.asarray(_eval(fm)(variables, jnp.asarray(x))["embeddings"])
    got = tm.eval()(torch.from_numpy(x))["embeddings"].detach().numpy()
    assert got.shape == want.shape == (3, 2, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Every convolution keeps an fp32 master, the bf16 model computes in bf16.
    bf16 = models.create("inception", depth=3, width=16, dtype=torch.bfloat16)
    assert bf16.block2.bdbl_2.conv.weight.dtype == torch.float32
    out = bf16.reset_parameters(torch.Generator().manual_seed(0)).eval()(
        torch.from_numpy(rng.normal(size=(2, 128, 64, 3)).astype(np.float32)))
    assert out["embeddings"].dtype == torch.float32 and bool(out["embeddings"].isfinite().all())


def test_cli_arch_inception(tmp_path):
    """``--arch inception`` (default depth and width) through the CLIs on
    the CPU: OIM pretraining (its table is as wide as the embedding), then
    SSG resumed from its checkpoint."""
    small = ["--arch", "inception", "--scale", "tiny", "--batch_size", "16", "--num_instances",
             "2", "--height", "64", "--width", "32", "--dtype", "float32", "--device", "cpu"]
    pre = tmp_path / "pre"
    assert pretraining.main(small + ["--epochs", "1", "--loss", "oim",
                                     "--logs_dir", str(pre)]) == 0
    ckpt = load_checkpoint(str(pre / "source_checkpoint.pth"))
    assert ckpt["lut"].shape == (15, 1024)
    assert ckpt["model"]["block7.bpool.bn.running_var"].shape == (256,)
    assert selftraining.main(small + [
        "--tgt_dataset", "dukemtmc", "--iteration", "1", "--epochs", "1", "--rho", "0.03",
        "--min_samples", "2", "--k1", "8", "--k2", "3", "--resume",
        str(pre / "source_checkpoint.pth"), "--logs_dir", str(tmp_path / "ssg")]) == 0
    assert (tmp_path / "ssg" / "checkpoint.pth").exists()


def test_factory_lists_inception():
    assert "inception" in models.names()
    # ``last_stride`` is a ResNet knob the factory accepts, as JAX's does.
    assert isinstance(models.create("inception", depth=1, width=8, last_stride=1),
                      models.SSGInception)
