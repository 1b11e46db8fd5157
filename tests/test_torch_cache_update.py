"""The port's cache slot write against the Pallas kernel (interpret mode)
and its wrapper's checks (the kernel itself: tests/test_torch_cuda.py).

Exact equality: the write copies values (the cast to the cache type rounds
the same way in both frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_tpu.ops.cache_update import cache_slot_write
from pasero_torch.ops.cache_update import (cache_slot_write_,
                                           cache_slot_write_plain)

B, H, L, D = 3, 4, 16, 64      # tests/test_cache_update.py
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, L, D), (B, H, L, D), (B, H, 1, D),
                          (B, H, 1, D))]


def _torch(array, dtype):
    return torch.from_numpy(array).to(dtype)


def _numpy(tensor):
    return tensor.float().numpy()


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
@pytest.mark.parametrize("index", [0, 7, L - 1])
@pytest.mark.parametrize("write", ["plain", "wrapper"])
def test_matches_pallas_kernel(jdtype, tdtype, index, write):
    k, v, k_new, v_new = _inputs(index)
    want_k = cache_slot_write(jnp.asarray(k, jdtype), jnp.asarray(k_new, jdtype),
                              index, force_pallas=True)
    want_v = cache_slot_write(jnp.asarray(v, jdtype), jnp.asarray(v_new, jdtype),
                              index, force_pallas=True)
    k_t, v_t = _torch(k, tdtype), _torch(v, tdtype)
    fn = cache_slot_write_plain if write == "plain" else cache_slot_write_
    # new blocks arrive in float32 and are cast to the cache type
    fn(k_t, v_t, torch.from_numpy(k_new), torch.from_numpy(v_new), index)
    np.testing.assert_array_equal(_numpy(k_t),
                                  np.asarray(want_k, np.float32))
    np.testing.assert_array_equal(_numpy(v_t),
                                  np.asarray(want_v, np.float32))


def test_cpu_wrapper_does_not_count_launches():
    k, v, k_new, v_new = (torch.from_numpy(a) for a in _inputs(0))
    before = cache_slot_write_.launches
    cache_slot_write_(k, v, k_new, v_new, 3)
    assert cache_slot_write_.launches == before


def test_new_block_from_transpose():
    # K/V come out of the projections as (B, 1, H, D) transposed to
    # (B, H, 1, D): the write must read them per (b, h), not by raw layout
    k, v, _, _ = (torch.from_numpy(a) for a in _inputs(1))
    rng = np.random.default_rng(2)
    k_new = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    v_new = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    cache_slot_write_(k, v, k_new.transpose(1, 2), v_new.transpose(1, 2), 5)
    torch.testing.assert_close(k[:, :, 5], k_new[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(v[:, :, 5], v_new[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["index_low", "index_high", "index_type",
                                  "shape", "new_shape", "dtype", "mixed_dtype",
                                  "new_dtype", "contiguity"])
def test_wrapper_rejects(case):
    k, v, k_new, v_new = (torch.from_numpy(a) for a in _inputs(0))
    index = 3
    error = ValueError
    if case == "index_low":
        index, error = -1, IndexError
    elif case == "index_high":
        index, error = L, IndexError
    elif case == "index_type":
        index, error = torch.tensor(3), TypeError
    elif case == "shape":
        k, v = k[:, :, :, :32], v[:, :, :, :32].contiguous()
    elif case == "new_shape":
        k_new = torch.zeros(B, H, 2, D)
    elif case == "dtype":
        k, v, error = k.half(), v.half(), TypeError
    elif case == "mixed_dtype":
        v, error = v.bfloat16(), TypeError
    elif case == "new_dtype":
        k_new, error = k_new.to(torch.int32), TypeError
    elif case == "contiguity":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    before = k.clone()
    with pytest.raises(error):
        cache_slot_write_(k, v, k_new, v_new, index)
    assert torch.equal(k, before)

