"""The float32 backward kernels' split-TF32 arithmetic, on the CPU.

csrc/flash_f32.cu's dq and dk/dv kernels take every product on the tensor
cores as hi_a hi_b + hi_a lo_b + lo_a hi_b of ``split_tf32``'s parts (Q, K,
V, dO, P and dS alike). Here that arithmetic, each product in float32, runs
the backward at two small shapes like ``FLASH_F32_CASES``' (T5, and ALiBi
with grouped K/V heads) and must lie within ``flash_f32_limits`` of
tests/test_torch_cuda.py, the limits the kernels are held to on the card;
one TF32 product (hi_a hi_b) must exceed them 2.8 times or more. The card's
own sums are checked there.
"""

from __future__ import annotations

import pytest
import torch

from pasero_torch.ops.flash_attention import (T5Bias, flash_bwd_plain,
                                              flash_fwd_plain, split_tf32,
                                              visible)

from test_torch_cuda import (flash_bias, flash_excess, flash_f32_limits,
                             flash_inputs, t5_table)

SHAPES = [   # (B, H, Hkv, S, D), causal, bias kind
    ((2, 4, 4, 96, 64), False, "t5"),
    ((2, 4, 2, 96, 64), True, "alibi"),
]


def product(a, b, single=False):
    """a @ b from split_tf32's parts, each product in float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = torch.matmul(ah, bh)
    return out if single else out + torch.matmul(ah, bl) + \
        torch.matmul(al, bh)


def split_bwd(q, k, v, mask, out, lse, do, scale, causal, bias, single):
    """(dq, dk, dv) with every product of ``product``: the float32
    kernels' dS = P (dP - delta), delta from out, dk and dv summed over a
    K/V head's query heads."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kg, vg = (x.repeat_interleave(group, 1) for x in (k, v))
    s = product(q, kg.transpose(-1, -2), single) * scale + bias
    ok = visible(mask, S, causal, None)
    p = torch.exp(s - lse[..., None]).masked_fill(~ok, 0.0)
    dp = product(do, vg.transpose(-1, -2), single)
    ds = p * (dp - (do * out).sum(-1, keepdim=True))
    dq = product(ds, kg, single) * scale
    dk = product(ds.transpose(-1, -2), q, single) * scale
    dv = product(p.transpose(-1, -2), do, single)
    return (dq,) + tuple(x.reshape(B, -1, group, S, D).sum(2)
                         for x in (dk, dv))


@pytest.mark.parametrize("shape,causal,kind", SHAPES,
                         ids=[kind for *_, kind in SHAPES])
def test_split_tf32_backward_within_float32_limits(shape, causal, kind):
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, True, device="cpu",
                                     dtype=torch.float32)
    if kind == "t5":
        t5 = T5Bias(t5_table(H, device="cpu"), True)
        bias_arg, dense = t5, t5.materialize(S, S)
    else:
        bias_arg = dense = flash_bias(kind, B, H, S, mask, device="cpu")
    rows = visible(mask, S, causal, None).any(-1).expand(B, H, S)
    do = do * rows[..., None]
    args = (D ** -0.5, causal, None)
    out, lse = flash_fwd_plain(q, k, v, mask, *args, bias_arg)
    want = flash_bwd_plain(q, k, v, mask, out, lse, do, *args, bias_arg)
    limits = flash_f32_limits(q, k, v, mask, lse, do, out, *args,
                              (out,) + tuple(want), dense)[1:]

    def excess(single):
        got = split_bwd(q, k, v, mask, out, lse, do, args[0], causal, dense,
                        single)
        return max(flash_excess(g, w, lim)
                   for g, w, lim in zip(got, want, limits))

    assert excess(False) <= 1.0
    assert excess(True) >= 2.8


def test_split_tf32_parts():
    """hi has TF32's 10 mantissa bits, rounded to nearest with ties away
    from zero; lo is the rest, rounded the same way."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      3.0, 1.0 + 2.0 ** -11 + 2.0 ** -20])
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                           1.0 + 2.0 ** -10]
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(hi + lo, x)   # each x here has at most 22 bits
