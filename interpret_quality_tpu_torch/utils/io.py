"""Logging and artifact IO.

The artifact schema (file names, folder layout, ``.pt`` logits tensors) is
the reference pipeline's persistence API; the port writes the same files as
the JAX package so that either package's tree feeds the same consumers.
"""
from __future__ import annotations

import os

import numpy as np
import torch


class IOStream:
    """Tee logger (reference tools/final_util.py:90-100); a context manager,
    so a stage that raises still closes its log.  ``mode="w"`` truncates:
    per-sample stage logs are rewritten whole on every (re)run."""

    def __init__(self, path: str, mode: str = "a"):
        self.f = open(path, mode)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def cprint(self, text: str):
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def mkdir(path: str):
    os.makedirs(path, exist_ok=True)


def save_npy(path: str, arr):
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    np.save(path, np.asarray(arr))


def save_torch_tensor(path: str, arr):
    """Save a CPU tensor as a ``.pt`` file, as the reference's
    ``torch.save(all_logits, ...)`` does (tools/final_common.py:170)."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.asarray(arr))
    torch.save(arr.detach().cpu(), path)


def load_torch_tensor(path: str) -> np.ndarray:
    """A ``.pt`` tensor as a numpy array, read on the CPU."""
    return torch.load(path, map_location="cpu").numpy()


def snapshot_sources(exp_dir: str, modules) -> list:
    """Copy the source files of ``modules`` into ``exp_dir`` as
    ``<name>.py.backup``, so a run can be traced to the code that made it
    (reference main_cls_seed.py:30-33).  Returns the paths written."""
    import shutil

    mkdir(exp_dir)
    written = []
    for mod in modules:
        src = getattr(mod, "__file__", None)
        if not src or not os.path.exists(src):
            continue
        dst = os.path.join(exp_dir, os.path.basename(src) + ".backup")
        shutil.copyfile(src, dst)
        written.append(dst)
    return written
