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

Training is data-parallel on every visible card (the JAX package's rule,
unscene3d_tpu/train/experiment.py:331): on a host with K > 1 cards whose
`data.batch_size` divides by K times the process count, the entry point
builds the CUDA kernels and the native library once, then spawns K ranks,
each on `cuda:<local_rank>`, over NCCL (parallel/distributed.py); narrow
the cards with CUDA_VISIBLE_DEVICES. Across hosts each host runs this
command under the JAX package's three variables:

  UNSCENE3D_COORDINATOR=host0:8476 UNSCENE3D_NUM_PROCESSES=2 \
  UNSCENE3D_PROCESS_ID=<0..1> python -m unscene3d_torch.main_instance_segmentation ...

and with `general.device=cpu` each process is one rank over gloo (the
counterpart of scripts/multihost_smoke.sh). Otherwise one rank runs, as
before. A rank that fails fails the run (a nonzero exit); nothing falls
back to fewer ranks or to the CPU. The test and the export run on process
0 alone, on one device, as the JAX evaluation does.
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


def train(cfg, device=None):
    exp = build_experiment(cfg, device)
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


def local_ranks(cfg) -> int:
    """The ranks this process runs: every visible card where training runs
    on CUDA on more than one and `data.batch_size` divides by the cards
    times UNSCENE3D_NUM_PROCESSES; else 1."""
    import torch

    from unscene3d_torch.parallel.distributed import env_processes

    device = torch.device(cfg.general.get("device") or "cuda")
    if device.type != "cuda" or device.index is not None:
        return 1
    cards = torch.cuda.device_count()
    nproc, _ = env_processes()
    if cards > 1 and int(cfg.data.batch_size) % (cards * nproc) == 0:
        return cards
    return 1


def _train_rank(local_rank, argv, ranks, coordinator):
    """One spawned rank on `cuda:<local_rank>`."""
    from unscene3d_torch.parallel import distributed as dp

    cfg = get_parameters(argv)
    device = f"cuda:{local_rank}"
    dp.initialize_from_env(device, ranks, coordinator)
    try:
        train(cfg, device)
    finally:
        dp.shutdown()


def main(argv=None):
    """Train (returning the trainer; None from the parent of spawned
    ranks) or test, as `general.train_mode` says."""
    from unscene3d_torch.parallel import distributed as dp

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = get_parameters(argv)
    nproc, pid = dp.env_processes()
    if not cfg.general.train_mode:
        if pid:
            print(f"[main] process {pid}: the test runs on process 0")
            return None
        return test(cfg)
    ranks = local_ranks(cfg)
    if ranks > 1:
        import torch.multiprocessing as mp

        from unscene3d_torch import native
        from unscene3d_torch.ops import _build

        native.build()
        _build.build()
        coordinator = (None if nproc > 1
                       else f"localhost:{dp.free_port()}")
        mp.spawn(_train_rank, args=(argv, ranks, coordinator), nprocs=ranks,
                 join=True)
        return None
    outside = dp.group() is None
    dp.initialize_from_env(cfg.general.get("device") or "cuda")
    try:
        return train(cfg)
    finally:
        if outside:
            dp.shutdown()


if __name__ == "__main__":
    main()
