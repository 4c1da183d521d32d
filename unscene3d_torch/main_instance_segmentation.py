"""Self-training entry point of the port (the counterpart of the repository's
main_instance_segmentation.py, reference main_instance_segmentation.py:21-114).

It takes the reference scripts' overrides unchanged, composes the
repository's conf/ (whose `_target_`s name the JAX package; the port's
loader builds its own classes of the same names) and runs on the GPU unless
the override `general.device=cpu` asks for the CPU:

  python -m unscene3d_torch.main_instance_segmentation \\
      general.experiment_name=DINO_CSC_self_train \\
      general.train_on_segments=true general.num_targets=3 \\
      data.batch_size=8 data/datasets=freemask \\
      general.data_dir=data/processed/unscene3d_dino_csc \\
      optimizer=adamw_lower trainer.max_epochs=70 \\
      general.checkpoint=saved/prev_round/best

`general.train_mode=false` runs the test and, with
`general.save_for_freemask=true`, exports the predictions that the next
round's `load_self_train_data` merges.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf", "config_base_instance_segmentation.yaml")


def get_parameters(overrides):
    """The composed config of conf/config_base_instance_segmentation.yaml
    under `overrides`; seeds numpy's global state from general.seed as the
    reference does."""
    from unscene3d_torch.config import load_config

    cfg = load_config(_CONF, overrides)
    np.random.seed(int(cfg.general.seed))
    return cfg


def build_experiment(cfg, device=None):
    """The Experiment of `cfg`: model, matcher, criterion, the three data
    sets and the two collators built from their config nodes. `device`
    defaults to the override `general.device`, else 'cuda'."""
    from unscene3d_torch.config import instantiate
    from unscene3d_torch.train.experiment import Experiment

    if device is None:
        device = cfg.general.get("device") or "cuda"
    model = instantiate(cfg.model)
    matcher = instantiate(cfg.matcher)
    criterion = instantiate(cfg.loss, matcher=matcher)
    train_ds = instantiate(cfg.data.datasets.train_dataset)
    val_ds = instantiate(cfg.data.datasets.validation_dataset)
    test_ds = instantiate(cfg.data.datasets.test_dataset)
    # the noise-robust loss reads the train batches' tri-plane maps; the
    # evaluation reads none (the JAX entry point builds them for both)
    collator = instantiate(
        cfg.data.collation_functions.train_collation,
        build_triplane=criterion.weight_noise_robust != 0.0)
    eval_collator = instantiate(
        cfg.data.collation_functions.validation_collation)
    return Experiment(cfg, model, criterion, train_ds, val_ds, test_ds,
                      collator, eval_collator=eval_collator, device=device)


def train(cfg):
    exp = build_experiment(cfg)
    try:
        return exp.fit(
            seed=int(cfg.general.seed),
            resume=bool(cfg.general.resume),
            checkpoint=cfg.general.checkpoint,
        )
    finally:
        exp.close()


def test(cfg):
    exp = build_experiment(cfg)
    try:
        return exp.test(
            checkpoint=cfg.general.checkpoint,
            save_for_freemask=bool(cfg.general.save_for_freemask),
        )
    finally:
        exp.close()


def main(argv=None):
    cfg = get_parameters(sys.argv[1:] if argv is None else argv)
    if cfg.general.train_mode:
        return train(cfg)
    return test(cfg)


if __name__ == "__main__":
    main()
