"""The counterpart of unscene3d_tpu/parallel/mesh.py.

There is no mesh: the process group of parallel/distributed.py does the
mesh's job, one rank per card. `replicate` is the counterpart of the JAX
`replicate`, which places one copy of the train state on every device: it
broadcasts rank 0's parameters, buffers and AdamW state. `make_mesh`,
`stack_shards` and `shard_leading_axis` have no counterpart: each rank
collates, holds and feeds its own batch shard, so no shards are stacked on
a device axis or placed across devices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _state_tensors(obj) -> list[torch.Tensor]:
    """Every tensor of a Trainer's state (the model's parameters and
    buffers, AdamW's moments, the step and count as one int64 tensor) or of
    a module's state_dict, in a fixed order."""
    model = getattr(obj, "model", obj)
    tensors = list(model.state_dict().values())
    opt = getattr(obj, "optimizer", None)
    if opt is not None:
        tensors += list(opt.mu) + list(opt.nu)
        tensors.append(torch.tensor([obj.step, opt.count], dtype=torch.int64,
                                    device=tensors[0].device))
    return tensors


@torch.no_grad()
def replicate(obj):
    """Broadcast rank 0's state of `obj` (a Trainer or an nn.Module) to
    every rank of the process group and assert that each rank already held
    it: the ranks build their state from one seed and restore the same
    files, so a rank that differs is a fault, and every rank raises
    RuntimeError. Returns `obj`."""
    tensors = _state_tensors(obj)
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    differs = torch.zeros(1, dtype=torch.int64, device=tensors[0].device)
    for ts in by_kind.values():
        own = torch.cat([t.reshape(-1) for t in ts])
        flat = own.clone()
        dist.broadcast(flat, src=0)
        if not torch.equal(flat, own):
            differs += 1
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    dist.all_reduce(differs, op=dist.ReduceOp.MAX)
    if int(differs.item()):
        raise RuntimeError("the ranks' train states differ from rank 0's "
                           "before replicate")
    return obj
