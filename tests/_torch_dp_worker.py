"""Rank functions of tests/test_torch_parallel.py, run in spawned processes.
They import torch and the port only (no JAX), so a rank starts in seconds.
Each rank pins torch to one thread, as the test process does, so that a
rank's CPU products sum in the same order as the in-process oracle's."""

import copy
import os

import numpy as np
import torch


class Pinned:
    """A matcher that answers with given indices (the JAX step's)."""

    def __init__(self, matched):
        self.matched = torch.from_numpy(np.array(matched)).long()

    def __call__(self, *args):
        return self.matched


def tiny_trainer(variables, matched, group=None, **kw):
    """The tiny f32 trainer of tests/test_torch_train.py carrying the JAX
    variables, its matcher pinned to `matched`."""
    import dataclasses

    from unscene3d_torch.models.weights import load_flax_variables
    from unscene3d_torch.train.loop import build_trainer

    trainer = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                            solver="scipy", device="cpu", group=group, **kw)
    load_flax_variables(trainer.model, variables)
    trainer.criterion = dataclasses.replace(trainer.criterion,
                                            matcher=Pinned(matched))
    return trainer


def step_rank(rank, world, coordinator, payload_path, out_dir):
    """One data-parallel step of the tiny model on this rank's shard over a
    gloo group, then `replicate` after rank 1's state was changed; writes
    the state after the step, the losses, the all-reduce's bytes and ms and
    whether replicate raised to `out_dir/rank<rank>.pt`."""
    import torch.distributed as dist

    from unscene3d_torch.parallel.distributed import rank_seed
    from unscene3d_torch.parallel.mesh import replicate

    torch.set_num_threads(1)
    payload = torch.load(payload_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    try:
        trainer = tiny_trainer(payload["variables"],
                               payload["matched"][rank],
                               group=dist.group.WORLD, **payload["kw"])
        replicate(trainer)
        gen = torch.Generator().manual_seed(rank_seed(0, rank))
        losses = trainer.train_step(payload["batches"][rank], gen)
        out = {"state": copy.deepcopy(trainer.state_dict()),
               "losses": losses, "comm": trainer.last_all_reduce()}
        # a rank whose state differs: replicate raises on every rank
        if rank == 1:
            with torch.no_grad():
                trainer.params[0].add_(1.0)
        try:
            replicate(trainer)
            out["replicate_raised"] = False
        except RuntimeError:
            out["replicate_raised"] = True
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def entry_rank(rank, world, coordinators, argv, out_dir):
    """Process `rank` of a CPU launch of the port's entry point under the
    UNSCENE3D_* variables: first a batch that does not divide by the ranks
    (it must raise ValueError), then one epoch with this rank's own save
    directory; writes the trainer's final state to `out_dir/rank<rank>.pt`
    and the refusal's message to `out_dir/refused<rank>.txt`."""
    from unscene3d_torch.main_instance_segmentation import main

    torch.set_num_threads(1)
    os.environ.update(UNSCENE3D_NUM_PROCESSES=str(world),
                      UNSCENE3D_PROCESS_ID=str(rank),
                      UNSCENE3D_COORDINATOR=coordinators[0])
    save = f"general.save_dir={out_dir}/save{rank}"
    try:
        main(argv + [save, "data.batch_size=3"])
    except ValueError as e:
        with open(os.path.join(out_dir, f"refused{rank}.txt"), "w") as f:
            f.write(str(e))
    os.environ["UNSCENE3D_COORDINATOR"] = coordinators[1]
    trainer = main(argv + [save])
    torch.save(trainer.state_dict(), os.path.join(out_dir, f"rank{rank}.pt"))
