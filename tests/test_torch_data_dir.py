"""The port's on-disk workflow against the JAX package, on the CPU:
``data.prepare`` (and ``cli.prepare``), ``DirectoryReID``, the native
loader binding, ``Preprocessor``'s native stream, and ``--data_dir`` in the
three CLIs.

Raw trees hold PPM bytes under the benchmarks' file names (both decoders
identify PPM by its magic bytes), written from the port's synthetic
renderer by ``chip_smoke.write_raw_market`` (the writer path 6 of
``chip_smoke.py`` uses) for Market-1501 / DukeMTMC-reID, and here for
MSMT17. Comparisons are exact: both packages run the same C++ sources (each
its own build) and the same PIL calls on the same files."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.data import native_loader as jax_native
from ssg_tpu.data.prepare import prepare as jax_prepare
from ssg_tpu.data.preprocessor import Preprocessor as JaxPreprocessor

from ssg_tpu_torch.cli import prepare as prepare_cli
from ssg_tpu_torch.cli import pretraining, selftraining, semitraining
from ssg_tpu_torch.data import datasets, native_loader
from ssg_tpu_torch.data.prepare import prepare
from ssg_tpu_torch.data.preprocessor import Preprocessor
from ssg_tpu_torch.data.synthetic import RAW_H, RAW_W
from ssg_tpu_torch.utils import read_json

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import write_ppm, write_raw_market  # noqa: E402

# 10 DukeMTMC identities a split (80 train, 20 query, 40 gallery images):
# a count no synthetic --scale of the CLI tests gives, so a run that read
# the synthetic stand-in instead of the tree shows in its log.
RAW_SCALE = 0.015
SIZES = {"train": 80, "query": 20, "gallery": 40}
SMALL = ["--scale", "tiny", "--batch_size", "16", "--num_instances", "2", "--arch", "resnet18",
         "--num_features", "16", "--height", "64", "--width", "32", "--dtype", "float32",
         "--device", "cpu"]
SSG = ["--tgt_dataset", "dukemtmc", "--iteration", "1", "--epochs", "1", "--rho", "0.03",
       "--min_samples", "2", "--k1", "8", "--k2", "3"]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw DukeMTMC-style tree: 3 gallery images at 128x64, junk files."""
    root = tmp_path_factory.mktemp("raw")
    ds = datasets.create("dukemtmc", scale=RAW_SCALE, seed=0)
    rows = write_raw_market(ds, str(root), odd=3)
    return root, rows


@pytest.fixture(scope="module")
def prepared(raw, tmp_path_factory):
    """The tree prepared by each package: (port root, JAX root)."""
    out = tmp_path_factory.mktemp("prepared")
    port, jax = out / "port" / "dukemtmc", out / "jax" / "dukemtmc"
    assert prepare("dukemtmc", str(raw[0]), str(port)) == jax_prepare("dukemtmc", str(raw[0]),
                                                                      str(jax))
    return port, jax


def _same_tree(a: Path, b: Path):
    for name in ("splits.json", "meta.json"):
        assert (a / name).read_text() == (b / name).read_text(), name
    assert sorted(os.listdir(a / "images")) == sorted(os.listdir(b / "images"))


def test_prepare_market_matches_jax(raw, prepared, tmp_path, capsys):
    port, jax = prepared
    _same_tree(port, jax)
    meta = read_json(str(port / "meta.json"))
    assert meta == {"num_train_ids": 10, "num_query_ids": 10, "images": 140}  # junk skipped
    (splits,) = read_json(str(port / "splits.json"))
    assert {k: len(v) for k, v in splits.items()} == SIZES
    fname, pid, cam = splits["gallery"][0]
    assert (pid, cam) == raw[1]["gallery"][0][1:3]  # cameras rebased to 0
    name = raw[1]["gallery"][0][0]
    assert os.path.samefile(port / "images" / fname, raw[0] / "bounding_box_test" / name)
    # The CLI prints what the root script prints, and prepares the same tree.
    import prepare as root_prepare

    out = tmp_path / "cli"
    argv = ["--dataset", "dukemtmc", "--raw_dir", str(raw[0])]
    assert prepare_cli.main(argv + ["--out_dir", str(out / "port")]) == 0
    assert root_prepare.main(argv + ["--out_dir", str(out / "jax")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("port", "jax") == lines[1]
    _same_tree(out / "port", port)
    with pytest.raises(KeyError):
        prepare("imagenet", str(raw[0]), str(tmp_path / "x"))


def test_prepare_msmt17_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    rng = np.random.default_rng(0)
    lists = {"list_train.txt": ("train", [(0, 1), (0, 2), (7, 1)]),
             "list_query.txt": ("test", [(3, 5)]),
             "list_gallery.txt": ("test", [(3, 7), (9, 15)])}
    for list_name, (sub, entries) in lists.items():
        lines = []
        for k, (pid, cam) in enumerate(entries):
            rel = f"{pid:04d}/{pid:04d}_{k:03d}_c{cam}_{k:04d}.jpg"
            (raw / sub / f"{pid:04d}").mkdir(parents=True, exist_ok=True)
            write_ppm(str(raw / sub / rel), rng.integers(0, 256, (32, 16, 3), dtype=np.uint8))
            lines.append(f"{rel} {pid}\n")
        (raw / list_name).write_text("".join(lines))
    port, jax = tmp_path / "port", tmp_path / "jax"
    splits = prepare("msmt17", str(raw), str(port))
    assert splits == jax_prepare("msmt17", str(raw), str(jax))
    _same_tree(port, jax)
    assert [c for _, _, c in splits["gallery"]] == [6, 14]


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Both packages decode natively, or both with their PIL fallback."""
    if request.param == "pil":
        monkeypatch.setattr(native_loader, "is_available", lambda: False)
        monkeypatch.setattr(jax_native, "is_available", lambda: False)
    else:
        assert native_loader.is_available(), native_loader.last_build_error()
    return request.param


def test_directory_reid_lists_and_render_match_jax(raw, prepared, decoder):
    port, jax = prepared
    ours = datasets.create("dukemtmc", root=str(port))
    ref = jax_datasets.create("dukemtmc", root=str(jax))
    assert isinstance(ours, datasets.DirectoryReID)
    assert ours.num_train_ids == ref.num_train_ids == 10
    for split, rows in raw[1].items():
        items = getattr(ours, split)
        assert items == getattr(ref, split)
        fnames = [f for f, _, _ in items]
        images = ours.render(fnames)
        np.testing.assert_array_equal(images, ref.render(fnames))
        assert images.shape == (len(items), RAW_H, RAW_W, 3)
        # The 256x128 files decode to the rendered pixels byte for byte.
        full = [k for k, r in enumerate(rows) if r[3] is not None]
        np.testing.assert_array_equal(images[full], np.stack([rows[k][3] for k in full]))


def test_create_without_a_tree_and_without_splits(tmp_path):
    syn = datasets.create("dukemtmc", root=str(tmp_path / "absent"), scale="tiny")
    ref = jax_datasets.create("dukemtmc", root=str(tmp_path / "absent"), scale="tiny")
    assert (syn.train, syn.query, syn.gallery) == (ref.train, ref.query, ref.gallery)
    # No splits.json: every image is train, named {pid:08d}_{cam:02d}_*.
    (tmp_path / "flat" / "images").mkdir(parents=True)
    for name in ("00000003_01_0000.jpg", "00000001_04_0000.png", "notes.txt"):
        write_ppm(str(tmp_path / "flat" / "images" / name), np.zeros((4, 2, 3), np.uint8))
    flat = datasets.create("x", root=str(tmp_path / "flat"))
    assert flat.train == jax_datasets.create("x", root=str(tmp_path / "flat")).train
    assert flat.train == [("00000001_04_0000.png", 1, 4), ("00000003_01_0000.jpg", 3, 1)]
    assert flat.num_train_ids == 2 and flat.query == flat.gallery == []
    one = tmp_path / "one_split"
    (one / "images").mkdir(parents=True)
    (one / "splits.json").write_text('[{"train": [], "query": [], "gallery": []}]')
    with pytest.raises(ValueError, match="split_id"):
        datasets.create("x", root=str(one), split_id=1)


def test_native_binding_matches_jax(raw, prepared, tmp_path):
    assert native_loader.is_available() and jax_native.is_available()
    assert native_loader.last_build_error() is None
    port = prepared[0] / "images"
    paths = sorted(str(port / f) for f in os.listdir(port))[:20]
    for path in paths[:4]:
        for h, w in ((RAW_H, RAW_W), (64, 32)):
            np.testing.assert_array_equal(native_loader.decode_resize(path, h, w),
                                          jax_native.decode_resize(path, h, w))
    ours = native_loader.load_batch(paths, 96, 48, num_threads=3)
    np.testing.assert_array_equal(ours, jax_native.load_batch(paths, 96, 48))
    with pytest.raises(IOError):
        native_loader.load_batch([paths[0], str(tmp_path / "missing.jpg")], 64, 32)
    loader = native_loader.BatchLoader(paths, batch_size=6, height=96, width=48)
    ref = jax_native.BatchLoader(paths, batch_size=6, height=96, width=48)
    try:
        for _ in range(2):  # the second epoch replays the first
            got, want = list(loader), list(ref)
            assert [v for _, v in got] == [v for _, v in want] == [6, 6, 6, 2]
            for (a, _), (b, _) in zip(got, want):
                np.testing.assert_array_equal(a, b)  # the tail's padding is zeros in both
    finally:
        loader.close()
        ref.close()
    built = Path(native_loader._lib_path())
    assert built.parent == REPO / "ssg_tpu_torch" / "_build" and built.exists()


def test_native_switch_and_build_failure(monkeypatch):
    """``SSG_TPU_NO_NATIVE`` forces the fallback; a failed build leaves the
    library unavailable and its compiler output readable."""
    for name, value in (("_lib", None), ("_load_attempted", False), ("_build_error", None)):
        monkeypatch.setattr(native_loader, name, value)
    monkeypatch.setenv("SSG_TPU_NO_NATIVE", "1")
    assert not native_loader.is_available()
    monkeypatch.delenv("SSG_TPU_NO_NATIVE")
    monkeypatch.setattr(native_loader, "_load_attempted", False)
    monkeypatch.setattr(native_loader, "LDLIBS", native_loader.LDLIBS + ["-lssg_no_such_lib"])
    assert not native_loader.is_available()
    assert "ssg_no_such_lib" in native_loader.last_build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.load_batch(["x.jpg"], 8, 8)
    assert not list(native_loader.BUILD_DIR.glob(f"*.{os.getpid()}.tmp"))  # removed


def test_preprocessor_native_stream_matches_jax(prepared, decoder, monkeypatch):
    """JAX's batches, masks, identities and cameras, the native stream's
    threads or not. The padding rows of the tail batch repeat its last
    image, as the port's stream has always padded (JAX's PIL path does the
    same; its native stream leaves the loader's zeros there)."""
    port, jax = prepared
    ours = datasets.create("dukemtmc", root=str(port))
    ref = jax_datasets.create("dukemtmc", root=str(jax))
    pre, jpre = Preprocessor(ours, batch_size=24), JaxPreprocessor(ref, batch_size=24)
    assert (pre._native_stream() is not None) == (decoder == "native")
    got, want = list(pre), list(jpre)
    assert len(got) == len(want) == 4  # 80 = 3 x 24 + 8
    for a, b in zip(got, want):
        mask = b[3]
        np.testing.assert_array_equal(a[0][mask], b[0][mask])
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    assert got[-1][3].tolist() == [True] * 8 + [False] * 16
    assert (got[-1][0][8:] == got[-1][0][7]).all()
    # The same batches whichever decoder made them.
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    for a, b in zip(got, Preprocessor(ours, batch_size=24)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cli,argv,line", [
    (pretraining, ["--dataset", "dukemtmc", "--epochs", "1"], "source dukemtmc: train=80 ids=10"),
    (selftraining, SSG, "target dukemtmc: train=80 query=20 gallery=40"),
    (semitraining, SSG, "target dukemtmc: train=80 one-shot=10 ids=10"),
], ids=["pretraining", "selftraining", "semitraining"])
def test_clis_read_the_data_dir(prepared, tmp_path, cli, argv, line):
    data_dir = str(prepared[0].parent)
    assert cli.main(SMALL + argv + ["--data_dir", data_dir, "--logs_dir", str(tmp_path)]) == 0
    assert line in (tmp_path / "log.txt").read_text()
