"""Host-side RNG discipline: permutation, pair and context sampling stays
host numpy with the reference's seeding scheme (tools/final_util.py:113-120),
so the port draws the same permutations, pairs and contexts as the JAX
package from the same seed."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random(seed: int):
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def cal_rank(values: np.ndarray) -> np.ndarray:
    """Rank of each value (0 = smallest); reference tools/final_util.py:103-106."""
    return np.argsort(np.argsort(values))
