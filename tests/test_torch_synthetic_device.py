"""The port's on-device synthetic renderer (``ssg_tpu_torch.data.
synthetic_device``) on the CPU: its deterministic core against the JAX
package's ``DeviceRenderer`` fed JAX's own draws, and JAX's renderer tests
(``tests/test_synthetic_device.py``) on the port's."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ssg_tpu.data.synthetic import SyntheticReID as JaxSyntheticReID
from ssg_tpu.data.synthetic import _seed_for
from ssg_tpu.data.synthetic_device import DeviceRenderer as JaxDeviceRenderer

from ssg_tpu_torch.data.synthetic import SyntheticReID
from ssg_tpu_torch.data.synthetic_device import DeviceRenderer, render


def _collect(renderer, items, bs):
    imgs, pids = [], []
    for images, p, _, mask in renderer.batches(items, bs):
        imgs.append(np.asarray(images)[mask])
        pids.append(p[mask])
    return np.concatenate(imgs), np.concatenate(pids)


def _jax_draws(fnames, seed):
    """The JAX renderer's per-item draws: the item's key split 3 ways (dy,
    dx, noise), as ``ssg_tpu/data/synthetic_device.py`` draws them."""
    dys, dxs, noises = [], [], []
    for f in fnames:
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(_seed_for(f, seed) % (2**31)), 3)
        dys.append(int(jax.random.randint(k1, (), -12, 13)))
        dxs.append(int(jax.random.randint(k2, (), -6, 7)))
        noises.append(np.asarray(0.03 * jax.random.normal(k3, (256, 128, 3), jnp.float32)))
    return torch.tensor(dys), torch.tensor(dxs), torch.from_numpy(np.stack(noises))


def test_core_fed_jax_draws_reproduces_jax_images():
    """Within one level, on at least 99.99 % of values: ``F.interpolate``
    and ``jax.image.resize`` differ by ~1e-7, which can move a value across
    a level's edge."""
    kw = dict(name="t", num_train_ids=5, num_test_ids=2, cams=3, seed=4)
    ours, ref = SyntheticReID(**kw), JaxSyntheticReID(**kw)
    items = ref.train[::3] + ref.query[:2]
    want, _ = _collect(JaxDeviceRenderer(ref), items, len(items))
    dy, dx, noise = _jax_draws([f for f, _, _ in items], ref.seed)
    got = render(torch.from_numpy(ours._palette), torch.from_numpy(ours._cam_tint),
                 torch.tensor([p for _, p, _ in items]), torch.tensor([c for _, _, c in items]),
                 dy, dx, noise).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.9999


def test_shapes_dtype_and_padding():
    ds = SyntheticReID(name="t", num_train_ids=4, num_test_ids=2, cams=3)
    r = DeviceRenderer(ds, device="cpu")
    batches = list(r.batches(ds.train, batch_size=10))
    assert all(tuple(b[0].shape) == (10, 256, 128, 3) for b in batches)
    assert batches[0][0].dtype == torch.uint8
    last = batches[-1]
    n = len(ds.train) % 10
    assert last[3].sum() == n and not last[3][n:].any()
    # A padding row repeats the last real item's image.
    assert torch.equal(last[0][n - 1], last[0][-1]) and last[1][-1] == last[1][n - 1]
    imgs, pids = _collect(r, ds.train, 10)
    assert len(imgs) == len(ds.train) and len(pids) == len(ds.train)


def test_deterministic_across_calls():
    ds = SyntheticReID(name="t", num_train_ids=3, num_test_ids=2, cams=2)
    r = DeviceRenderer(ds, device="cpu")
    a, _ = _collect(r, ds.train[:6], 4)
    b, _ = _collect(r, ds.train[:6], 4)
    np.testing.assert_array_equal(a, b)


def test_identity_dominates_appearance():
    """Same-id image pairs are closer in pixel space than cross-id pairs
    (the property that makes clustering benchmarks meaningful)."""
    ds = SyntheticReID(name="t", num_train_ids=6, num_test_ids=2, cams=3)
    imgs, pids = _collect(DeviceRenderer(ds, device="cpu"), ds.train, 16)
    x = imgs.reshape(len(imgs), -1).astype(np.float32) / 255.0
    d = ((x[:, None] - x[None, :]) ** 2).mean(-1)
    same = pids[:, None] == pids[None, :]
    off = ~np.eye(len(x), dtype=bool)
    assert d[same & off].mean() * 2 < d[~same].mean()


def test_pixels_do_not_depend_on_the_batch_size():
    ds = SyntheticReID(name="t", num_train_ids=3, num_test_ids=2, cams=2, seed=1)
    r = DeviceRenderer(ds, device="cpu")
    a, pa = _collect(r, ds.train[:13], 4)
    b, pb = _collect(r, ds.train[:13], 7)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pa, pb)
