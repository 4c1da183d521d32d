"""Train-state checkpoints in torch's own format, with the directory
contract of unscene3d_tpu/train/checkpoint.py (orbax there):

  * `save_checkpoint(dir, trainer)` writes `dir/<step>/state.pt`, the
    trainer's state (`Trainer.state_dict`: the step, the model's
    parameters, BatchNorm running statistics and buffers, AdamW's moments
    and count) as CPU tensors. It writes a temp directory and renames it,
    so a reader never sees half a checkpoint; a checkpoint of the same step
    is replaced.
  * `latest_step(dir)`: the largest step saved there, or None.
  * `restore_checkpoint(dir, trainer)`: exact restore of the latest (or a
    given) step.
  * `restore_partial(dir, trainer)`: the reference's
    `load_state_with_same_shape` (utils/utils.py:146-192): model tensors
    whose name exists in both and whose shape matches come from the
    checkpoint, the rest (a class head that `num_targets` resized) and the
    optimizer state and step stay the trainer's own (fresh).

Under a data-parallel process group only rank 0 writes (`save_checkpoint`
returns the path on every rank; the caller's barrier orders the ranks);
every rank restores the same files, so `restore_checkpoint` and
`restore_partial` leave every rank with the same state, which
parallel/mesh.py:replicate asserts.
"""

from __future__ import annotations

import os
import shutil

import torch

from unscene3d_torch.parallel.distributed import is_main

_STATE_FILE = "state.pt"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_cpu(v) for v in obj]
    return obj


def save_checkpoint(ckpt_dir: str, trainer, step: int | None = None) -> str:
    """Save `trainer.state_dict()` as step `step` (default: the trainer's);
    returns the checkpoint's directory. Writes on rank 0 only."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    step = int(trainer.step) if step is None else int(step)
    if not is_main():
        return os.path.join(ckpt_dir, str(step))
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(trainer.state_dict()), os.path.join(tmp, _STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d,
                                                            _STATE_FILE))]
    return max(steps) if steps else None


def load_state(ckpt_dir: str, step: int | None = None) -> dict:
    """The saved state of `step` (default: the latest) as CPU tensors."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return torch.load(os.path.join(ckpt_dir, str(step), _STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, trainer, step: int | None = None):
    """Exact restore into `trainer` (same names and shapes); returns it."""
    trainer.load_state_dict(load_state(ckpt_dir, step))
    return trainer


def load_with_same_shape(template: dict, loaded: dict,
                         verbose: bool = False) -> dict:
    """`template` (name -> tensor) with each entry whose name is in
    `loaded` at the same shape replaced by the loaded tensor."""
    out, matched = {}, 0
    for name, t in template.items():
        v = loaded.get(name)
        if v is not None and tuple(v.shape) == tuple(t.shape):
            out[name] = v
            matched += 1
        else:
            out[name] = t
            if verbose and v is not None:
                print(f"shape mismatch at {name}: {tuple(v.shape)} vs "
                      f"{tuple(t.shape)}")
    if verbose:
        print(f"restored {matched}/{len(template)} matching tensors")
    return out


def restore_partial(ckpt_dir: str, trainer, step: int | None = None,
                    verbose: bool = True):
    """Shape-tolerant restore of the model's tensors; the optimizer state
    and the step stay the trainer's. Returns the trainer."""
    loaded = load_state(ckpt_dir, step)["model"]
    own = trainer.model.state_dict()
    trainer.model.load_state_dict(
        load_with_same_shape(own, loaded, verbose=verbose), strict=True)
    return trainer
