"""Kernel 8, the grouped row gather, on the CPU: the plain version that the
wrapper takes for CPU tensors against the JAX package's Pallas
``gather_rows`` (interpret mode, ``parts=2``: hi/lo bf16 value planes, about
2^-16 relative, hence atol 5e-5 as in the JAX package's own test), and
exactly against a numpy gather.  The CUDA kernel is held bit-equal to the
plain version on the card (tests/test_torch_cuda.py, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.ops.pallas import gather_rows as pallas_gather_rows
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import launch


def test_plain_gather_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    a = rng.randn(3, 64, 16).astype(np.float32)
    idx = np.random.RandomState(6).randint(0, 64, (3, 24, 5)).astype(np.int32)
    want = np.asarray(pallas_gather_rows(jnp.asarray(a), jnp.asarray(idx),
                                         parts=2, interpret=True))
    got = gr.gather_rows_plain(torch.from_numpy(a), torch.from_numpy(idx))
    assert got.shape == (3, 24, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("F", [7, 130])
def test_gather_is_an_exact_copy(F):
    """F neither a multiple of 4 nor of 128; the wrapper on CPU tensors
    takes the plain version and counts no launch."""
    rng = np.random.RandomState(F)
    a = rng.randn(2, 50, F).astype(np.float32)
    idx = rng.randint(0, 50, (2, 33, 4)).astype(np.int32)
    launch.reset_launches()
    got = gr.gather_rows(torch.from_numpy(a), torch.from_numpy(idx)).numpy()
    want = a[np.arange(2)[:, None, None], idx]              # (2, 33, 4, F)
    np.testing.assert_array_equal(got, want)
    assert launch.LAUNCHES["gather_rows"] == 0


def test_off_cpu_tensors_never_reach_the_plain_version():
    values = torch.empty(2, 16, 8, device="meta")
    idx = torch.empty(2, 4, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gr.gather_rows(values, idx)
