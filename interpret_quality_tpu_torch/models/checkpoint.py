"""Checkpoint loading for the CLIs (counterpart of
``interpret_quality_tpu/models/checkpoint.py``): a reference-layout
``.t7/.pth/.pt`` state dict, or a flax ``.msgpack`` file that the JAX
package wrote (``save_variables``), read without flax.

A flax ``.msgpack`` file is the msgpack encoding of the variables' nested
dict, with extension types (``flax/serialization.py``) of which a
checkpoint uses two: 1, an array packed as the msgpack triple (shape, dtype
name, C-order bytes), and 3, a numpy scalar, packed as a 0-d array.  Arrays
above 2**30 bytes are split into a dict
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
whose tuples are dicts keyed "0", "1", ...
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .convert import load_reference_state_dict, state_dict_from_jax

TORCH_SUFFIXES = (".t7", ".pth", ".pt")
_CHUNKED = "__msgpack_chunked_array__"


def _array_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _unchunk(tree):
    """Chunked array leaves back into arrays (flax ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def read_msgpack(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays in a flax ``.msgpack`` file."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the 'msgpack' package (pip install "
            "msgpack); a reference .t7 state dict needs only torch") from e

    def ext_hook(code, data):
        if code == 1:
            return _array_from_bytes(msgpack, data)
        if code == 3:
            return _array_from_bytes(msgpack, data)[()]
        raise ValueError(f"{path}: msgpack extension type {code} is not "
                         "part of a flax checkpoint of arrays")

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def load_checkpoint(model_name: str, path: str) -> Dict[str, torch.Tensor]:
    """The port model's state dict from a checkpoint in either format: a
    ``.t7/.pth/.pt`` reference state dict as it is, a ``.msgpack`` file of
    JAX variables through ``state_dict_from_jax``."""
    if path.endswith(TORCH_SUFFIXES):
        return load_reference_state_dict(path)
    return state_dict_from_jax(model_name, read_msgpack(path))
