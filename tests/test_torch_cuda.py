"""The port's hand-written kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports torch only, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pasero_torch.ops.cache_update import (cache_slot_write_,
                                           cache_slot_write_plain)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((320, 8, 72, 64), torch.bfloat16),   # full-width decode: 16-byte copies
    ((3, 4, 17, 18), torch.float32),      # 72-byte rows: scalar copies
    ((3, 4, 17, 36), torch.bfloat16),
])
def test_cache_slot_write_matches_plain(shape, dtype):
    """Bitwise equal, with the new block as a transposed view and in float32
    (the wrapper casts it to the cache's type)."""
    _need_card()
    R, H, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    for index in (0, L // 2, L - 1):
        k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k_new = torch.randn((R, 1, H, D), generator=gen,
                            device="cuda").transpose(1, 2)
        v_new = torch.randn((R, 1, H, D), generator=gen,
                            device="cuda").transpose(1, 2)
        k2, v2 = k.clone(), v.clone()
        before = cache_slot_write_.launches
        cache_slot_write_(k, v, k_new, v_new, index)
        cache_slot_write_plain(k2, v2, k_new, v_new, index)
        torch.cuda.synchronize()
        assert cache_slot_write_.launches == before + 1
        assert torch.equal(k, k2) and torch.equal(v, v2)


@pytest.mark.cuda
def test_cache_slot_write_raises_on_card():
    """On CUDA tensors the wrapper launches or raises; a slot outside the
    cache launches nothing."""
    _need_card()
    k = torch.zeros((2, 3, 5, 8), device="cuda")
    new = torch.ones((2, 3, 1, 8), device="cuda")
    before = cache_slot_write_.launches
    with pytest.raises(IndexError):
        cache_slot_write_(k, k.clone(), new, new, 5)
    assert cache_slot_write_.launches == before
