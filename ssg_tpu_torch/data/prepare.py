"""Raw-dataset preparation: benchmark trees -> the open-reid layout.

The port's own copy of ``ssg_tpu/data/prepare.py``: the same tree gives the
same ``images/`` names, ``splits.json`` and ``meta.json`` in both packages.
The reference's dataset classes ([reid/datasets/market1501.py] et al.,
SURVEY.md §2 #11) ingest each benchmark's raw distribution, rename images to
``{pid:08d}_{camid:02d}_{idx:04d}.jpg`` under ``images/``, and write
``meta.json`` + ``splits.json``. This module reproduces that step so a user
with the raw zips can feed DirectoryReID (and the native loader):

  * Market-1501 / DukeMTMC-reID: ``bounding_box_train`` / ``query`` /
    ``bounding_box_test`` directories, filenames ``{pid}_c{cam}s...`` —
    pid -1 (distractor junk) skipped, cameras 1-based.
  * MSMT17: ``train`` / ``test`` directories with ``list_train.txt`` /
    ``list_query.txt`` / ``list_gallery.txt`` index files, filenames contain
    ``_c{cam}_`` (1-based).

Files are hard-linked when possible (no duplicate storage), else copied.
"""

from __future__ import annotations

import os
import re
import shutil

from ssg_tpu_torch.utils.serialization import mkdir_if_missing, write_json

_MARKET_RE = re.compile(r"^(-?\d+)_c(\d+)")
_MSMT_RE = re.compile(r"_c(\d+)_")


def _place(src: str, images_dir: str, pid: int, cam: int, idx: int) -> str:
    fname = f"{pid:08d}_{cam:02d}_{idx:04d}.jpg"
    dst = os.path.join(images_dir, fname)
    if not os.path.exists(dst):
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)
    return fname


def _scan_market_dir(raw_dir: str):
    """Yield (path, pid, cam0) for a Market/Duke-style directory."""
    for name in sorted(os.listdir(raw_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        m = _MARKET_RE.match(name)
        if not m:
            continue
        pid, cam = int(m.group(1)), int(m.group(2))
        if pid < 0:  # junk/distractor images (pid -1) are skipped
            continue
        yield os.path.join(raw_dir, name), pid, cam - 1


def prepare_market1501(raw_root: str, out_root: str) -> dict:
    """Market-1501 / DukeMTMC-reID raw tree -> open-reid layout at out_root.

    Expects ``bounding_box_train`` / ``query`` / ``bounding_box_test`` under
    ``raw_root``. Returns the split dict written to splits.json.
    """
    images_dir = os.path.join(out_root, "images")
    mkdir_if_missing(images_dir)
    counters: dict[tuple[int, int], int] = {}
    splits = {"train": [], "query": [], "gallery": []}
    dirs = {
        "train": "bounding_box_train",
        "query": "query",
        "gallery": "bounding_box_test",
    }
    for split, sub in dirs.items():
        raw_dir = os.path.join(raw_root, sub)
        if not os.path.isdir(raw_dir):
            raise FileNotFoundError(raw_dir)
        for path, pid, cam in _scan_market_dir(raw_dir):
            idx = counters.get((pid, cam), 0)
            counters[(pid, cam)] = idx + 1
            fname = _place(path, images_dir, pid, cam, idx)
            splits[split].append((fname, pid, cam))
    _write_meta(out_root, splits)
    return splits


def prepare_msmt17(raw_root: str, out_root: str) -> dict:
    """MSMT17 raw tree (train/ test/ + list_*.txt) -> open-reid layout."""
    images_dir = os.path.join(out_root, "images")
    mkdir_if_missing(images_dir)
    counters: dict[tuple[int, int], int] = {}
    splits = {"train": [], "query": [], "gallery": []}
    lists = {
        "train": ("train", "list_train.txt"),
        "query": ("test", "list_query.txt"),
        "gallery": ("test", "list_gallery.txt"),
    }
    for split, (sub, list_name) in lists.items():
        list_path = os.path.join(raw_root, list_name)
        if not os.path.exists(list_path):
            raise FileNotFoundError(list_path)
        with open(list_path) as f:
            for line in f:
                rel, pid_s = line.split()
                pid = int(pid_s)
                m = _MSMT_RE.search(os.path.basename(rel))
                cam = int(m.group(1)) - 1 if m else 0
                idx = counters.get((pid, cam), 0)
                counters[(pid, cam)] = idx + 1
                fname = _place(os.path.join(raw_root, sub, rel), images_dir,
                               pid, cam, idx)
                splits[split].append((fname, pid, cam))
    _write_meta(out_root, splits)
    return splits


def _write_meta(out_root: str, splits: dict):
    write_json([splits], os.path.join(out_root, "splits.json"))
    write_json(
        {
            "num_train_ids": len({p for _, p, _ in splits["train"]}),
            "num_query_ids": len({p for _, p, _ in splits["query"]}),
            "images": sum(len(v) for v in splits.values()),
        },
        os.path.join(out_root, "meta.json"),
    )


PREPARERS = {
    "market1501": prepare_market1501,
    "dukemtmc": prepare_market1501,  # same raw layout/naming convention
    "msmt17": prepare_msmt17,
}


def prepare(name: str, raw_root: str, out_root: str) -> dict:
    if name not in PREPARERS:
        raise KeyError(f"No preparer for {name!r}; known: {sorted(PREPARERS)}")
    return PREPARERS[name](raw_root, out_root)
