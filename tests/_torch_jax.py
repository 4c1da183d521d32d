"""Helpers shared by the PyTorch-port parity tests: JAX variables as plain
numpy trees, with random BatchNorm state so folded epilogues do real work,
and a fixture that runs a module's torch ops on one thread."""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread for the module that imports this. The
    tiny models' ops are too small to gain from threads, and on a loaded
    host (the suite's parallel workers) each multi-threaded op waits on its
    descheduled threads: with every core of an 8-core host busy, the tiny
    Mask3D forward took ~0.2 s on one thread and ~15 s on eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    """A (Frozen)dict tree of arrays as nested dicts of writable numpy
    arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def random_bn(variables, seed=0):
    """numpy copy of `variables` with random BatchNorm statistics (mean,
    var) and affine params (scale, bias)."""
    rng = np.random.RandomState(seed)
    v = np_tree(variables)

    def walk(stats, params):
        for k, sub in stats.items():
            if "mean" in sub:
                sub["mean"] = (rng.randn(*sub["mean"].shape) * 0.1
                               ).astype(np.float32)
                sub["var"] = (rng.rand(*sub["var"].shape) + 0.5
                              ).astype(np.float32)
                p = params[k]
                p["scale"] = (rng.rand(*p["scale"].shape) + 0.5
                              ).astype(np.float32)
                p["bias"] = (rng.randn(*p["bias"].shape) * 0.1
                             ).astype(np.float32)
            else:
                walk(sub, params[k])

    walk(v["batch_stats"], v["params"])
    return v
