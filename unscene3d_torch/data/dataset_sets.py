"""Fixed scene subsets (the port's own copy of
unscene3d_tpu/data/dataset_sets.py; the role of the reference's
pseudo_masks/constants/dataset_sets.py, the official ScanNet v2 train/val
splits).

The lists are read from the standard split files (`scannetv2_train.txt` /
`scannetv2_val.txt`, shipped with every ScanNet download, or the per-dataset
`train.txt` / `val.txt`), searched in an explicit directory, then in
`$SCANNET_SPLITS_DIR`. Consumers: eval CLIs restricting to the validation
scenes (reference pseudo_masks/eval_cutler_images.py:13,79).
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path

_CANDIDATES = {
    "train": ("scannetv2_train.txt", "train.txt"),
    "val": ("scannetv2_val.txt", "val.txt"),
    "test": ("scannetv2_test.txt", "test.txt"),
}


@lru_cache(maxsize=None)
def scene_set(split: str, splits_dir: str | None = None) -> tuple[str, ...]:
    """Scene names for `split` in {'train', 'val', 'test'}; an empty tuple
    when no split file can be found (callers then glob the dataset)."""
    roots = []
    if splits_dir:
        roots.append(Path(splits_dir))
    env = os.environ.get("SCANNET_SPLITS_DIR")
    if env:
        roots.append(Path(env))
    for root in roots:
        for fname in _CANDIDATES.get(split, ()):
            p = root / fname
            if p.exists():
                return tuple(ln.strip() for ln in p.read_text().splitlines()
                             if ln.strip())
    return ()


def train_scenes(splits_dir: str | None = None) -> tuple[str, ...]:
    return scene_set("train", splits_dir)


def val_scenes(splits_dir: str | None = None) -> tuple[str, ...]:
    return scene_set("val", splits_dir)
