"""The float32 flash kernels' split-TF32 arithmetic, on the CPU.

csrc/flash_f32.cu's forward, dq, dk/dv and dbias kernels take every
product on the tensor cores as hi_a hi_b + hi_a lo_b + lo_a hi_b of
``split_tf32``'s parts (Q, K, V, dO, P and dS alike). Here that arithmetic,
each product in float32, runs the backward at two small shapes like
``FLASH_F32_CASES``' (T5, and ALiBi with grouped K/V heads), and the forward
as the kernel orders it (key tiles of TN keys, the online softmax's
rescale, each tile's P V added with one float32 add) at those and at a
bias-free GQA shape; both must lie within ``flash_f32_limits`` of
tests/test_torch_cuda.py, the limits the kernels are held to on the card,
and one TF32 product (hi_a hi_b) must exceed them 2.8 times or more. dbias
(a per-sample, a shared and a (1, 1) bias, the batch summed in the
kernel's order) likewise against ``flash_dbias_limits``. The card's own
sums are checked there.

The T5 dq kernel's demb (its DEMB instance) sums a consumer's 64 x TN tile
of dS by the host's plan of far tiles, made for 64 x 64 tiles
(``T5Bias.far_tiles``): here that plan holds at the float32 kernels' tiles
of 64 rows x 64, 32 and 16 keys (every distance of a far tile in its
side's bucket), and dS summed by the kernel's decomposition (far tiles by
side, near ones by bucket, per 64-row query tile) equals the plain
version's demb.
"""

from __future__ import annotations

import pytest
import torch

from pasero_torch.ops.flash_attention import (NEG_INF, T5Bias, _dscores,
                                              _reduce_to, flash_bwd_plain,
                                              flash_dbias_plain,
                                              flash_demb_plain,
                                              flash_fwd_plain, split_tf32,
                                              visible)

from test_torch_cuda import (F32_LSE_ATOL, flash_bias, flash_dbias_limits,
                             flash_demb_limits, flash_excess,
                             flash_f32_limits, flash_inputs, t5_table)

SHAPES = [   # (B, H, Hkv, S, D), causal, bias kind
    ((2, 4, 4, 96, 64), False, "t5"),
    ((2, 4, 2, 96, 64), True, "alibi"),
]
FWD_SHAPES = SHAPES + [((2, 4, 2, 96, 64), True, None)]   # bias-free GQA
TN = {32: 64, 64: 32, 128: 16}   # the kernels' keys a tile, by head dim


def product(a, b, single=False):
    """a @ b from split_tf32's parts, each product in float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = torch.matmul(ah, bh)
    return out if single else out + torch.matmul(ah, bl) + \
        torch.matmul(al, bh)


def split_fwd(q, k, v, mask, scale, causal, bias, single):
    """(out, lse) as the forward kernel orders them: per key tile of TN
    keys S = Q K^T (``product``), the row's new max m, the output and row
    sum rescaled by exp(m_old - m), P = exp(S - m), and the tile's P V
    (``product``) added with one float32 add; out = acc / l, lse = m +
    log(l)."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kg, vg = (x.repeat_interleave(group, 1) for x in (k, v))
    ok = visible(mask, S, causal, None)
    m = torch.full((B, H, S, 1), float("-inf"))
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros_like(q)
    for k0 in range(0, S, TN[D]):
        cols = slice(k0, k0 + TN[D])
        s = product(q, kg[:, :, cols].transpose(-1, -2), single) * scale + \
            bias[..., cols]
        s = s.masked_fill(~ok[..., cols], float("-inf"))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(mn == float("-inf"), 0.0, mn)
        alpha = torch.exp(m - mu)
        p = torch.exp(s - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product(p, vg[:, :, cols], single)
        m = mn
    empty = l == 0
    out = torch.where(empty, 0.0, acc / torch.where(empty, 1.0, l))
    lse = torch.where(empty, NEG_INF, m + torch.log(torch.where(empty, 1.0,
                                                                l)))
    return out, lse[..., 0]


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


def case_inputs(shape, causal, kind):
    """q, k, v, dO (zero on rows that see no key), the key mask, the bias
    argument of the plain version and its dense (broadcast) bias."""
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, True, device="cpu",
                                     dtype=torch.float32)
    if kind == "t5":
        t5 = T5Bias(t5_table(H, device="cpu"), True)
        bias_arg, dense = t5, t5.materialize(S, S)
    elif kind is None:
        bias_arg, dense = None, torch.zeros(1, 1, S, S)
    else:
        bias_arg = dense = flash_bias(kind, B, H, S, mask, device="cpu")
    rows = visible(mask, S, causal, None).any(-1).expand(B, H, S)
    return q, k, v, do * rows[..., None], mask, bias_arg, dense, rows


@pytest.mark.parametrize("shape,causal,kind", FWD_SHAPES,
                         ids=[str(kind) for *_, kind in FWD_SHAPES])
def test_split_tf32_forward_within_float32_limits(shape, causal, kind):
    q, k, v, do, mask, bias_arg, dense, rows = case_inputs(shape, causal,
                                                           kind)
    args = (shape[-1] ** -0.5, causal, None)
    out, lse = flash_fwd_plain(q, k, v, mask, *args, bias_arg)
    want = flash_bwd_plain(q, k, v, mask, out, lse, do, *args, bias_arg)
    limit = flash_f32_limits(q, k, v, mask, lse, do, out, *args,
                             (out,) + tuple(want),
                             None if bias_arg is None else dense)[0]
    got, got_lse = split_fwd(q, k, v, mask, args[0], causal, dense, False)
    assert flash_excess(got, out, limit, rows) <= 1.0
    assert (got_lse - lse)[rows].abs().max().item() <= F32_LSE_ATOL
    single = split_fwd(q, k, v, mask, args[0], causal, dense, True)[0]
    assert flash_excess(single, out, limit, rows) >= 2.8


DBIAS_SHAPES = [   # (B, H, Hkv, S, D), causal, bias kind
    ((2, 4, 2, 96, 64), True, "alibi"),         # per sample: (B, H)
    ((4, 4, 2, 96, 64), True, "learned_1xH"),   # shared over four batches
    ((3, 4, 2, 80, 32), False, "1x1"),          # and summed over the heads
]


def split_dbias(q, k, v, mask, out, lse, do, scale, causal, bias, single):
    """dbias as the float32 dbias kernel forms it: per batch dS = P (dP -
    delta), S = Q K^T and dP = dO V^T from ``product``, P = exp(S scale +
    bias - lse), 0 where a key is not visible; for a bias shared over the
    batch the batches added to 0 in order, in float32; then summed over the
    heads where the bias has one (``_reduce_to``, after the kernel)."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kg, vg = (x.repeat_interleave(group, 1) for x in (k, v))
    s = product(q, kg.transpose(-1, -2), single) * scale + bias
    ok = visible(mask, S, causal, None)
    p = torch.exp(s - lse[..., None]).masked_fill(~ok, 0.0)
    dp = product(do, vg.transpose(-1, -2), single)
    ds = p * (dp - (do * out).sum(-1, keepdim=True))
    if bias.shape[0] == 1 and B > 1:
        acc = torch.zeros_like(ds[:1])
        for b in range(B):
            acc = acc + ds[b:b + 1]
        ds = acc
    return _reduce_to(ds, bias.shape)


@pytest.mark.parametrize("shape,causal,kind", DBIAS_SHAPES,
                         ids=[kind for *_, kind in DBIAS_SHAPES])
def test_split_tf32_dbias_within_float32_limits(shape, causal, kind):
    """The dbias kernel's split-TF32 dS, summed over the batch in its order,
    within ``flash_dbias_limits`` of the plain version; one TF32 product 2.8
    times outside them or more."""
    q, k, v, do, mask, bias, _, _ = case_inputs(shape, causal, kind)
    args = (shape[-1] ** -0.5, causal, None)
    out, lse = flash_fwd_plain(q, k, v, mask, *args, bias)
    want = flash_dbias_plain(q, k, v, mask, out, lse, do, *args, bias)
    limit = flash_dbias_limits(q, k, v, mask, lse, do, out, *args, bias,
                               want)

    def excess(single):
        got = split_dbias(q, k, v, mask, out, lse, do, args[0], causal, bias,
                          single)
        return flash_excess(got, want, limit)

    assert excess(False) <= 1.0
    assert excess(True) >= 2.8


# (Sq, Sk, bidirectional, num_buckets, max_distance): t5_base's encoder and
# decoder buckets past a tile's reach, and a short max_distance with far
# tiles on both sides at a few hundred keys
PLANS = [(520, 520, True, 32, 128), (300, 130, False, 32, 128),
         (333, 270, True, 16, 24), (200, 330, False, 8, 16)]


def far_tile_offsets(t5, Sq, Sk, tn):
    """(q0, k0, side) of every 64 x tn tile the plan marks far, side 0 for
    its first bucket, 1 for its last, as the kernel decides it (the tile's
    key offset rounded down to 64)."""
    neg, pos, _, _ = t5.far_tiles(Sq, Sk)
    for q0 in range(0, Sq, 64):
        for k0 in range(0, Sk, tn):
            offset = (k0 & ~63) - q0
            if offset >= pos or offset <= neg:
                yield q0, k0, int(offset >= pos)


@pytest.mark.parametrize("plan", PLANS, ids=[str(p[:3]) for p in PLANS])
def test_far_plan_holds_at_float32_tiles(plan):
    Sq, Sk, bidirectional, nb, max_distance = plan
    t5 = T5Bias(torch.zeros(nb, 1), bidirectional, nb, max_distance)
    _, _, b_neg, b_pos = t5.far_tiles(Sq, Sk)
    buckets = t5.buckets(Sq, Sk)
    far = 0
    for tn in (64, 32, 16):
        for q0, k0, side in far_tile_offsets(t5, Sq, Sk, tn):
            tile = buckets[q0:q0 + 64, k0:k0 + tn]
            assert (tile == (b_pos if side else b_neg)).all(), (tn, q0, k0)
            far += 1
    assert far > 0   # the plan marks some tiles at these shapes


def kernel_demb(ds, t5, tn, plan=None):
    """T5's table gradient (num_buckets, H) from dS (B, H, Sq, Sk) by the
    DEMB dq kernel's decomposition: per 64-row query tile, the 64 x tn
    tiles in key order, a far one (by ``plan``, the host's by default)
    summed into its side, a near one by bucket; the near sums, then the far
    ones added to the plan's first and last buckets; the tiles' rows summed
    over the batch and the query tiles."""
    B, H, Sq, Sk = ds.shape
    neg, pos, b_neg, b_pos = plan or t5.far_tiles(Sq, Sk)
    index = t5.index(Sq, Sk).long()
    rows = []
    for q0 in range(0, Sq, 64):
        near = torch.zeros(B, H, t5.num_buckets)
        far = torch.zeros(B, H, 2)
        for k0 in range(0, Sk, tn):
            tile = ds[:, :, q0:q0 + 64, k0:k0 + tn]
            offset = (k0 & ~63) - q0
            if offset >= pos or offset <= neg:
                far[..., int(offset >= pos)] += tile.sum((-1, -2))
                continue
            r = torch.arange(tile.shape[-2])[:, None] + q0
            c = torch.arange(tile.shape[-1])[None] + k0
            bk = index[(c - r + Sq - 1).clamp(0, Sq + Sk - 2)].reshape(-1)
            near.index_add_(2, bk, tile.reshape(B, H, -1))
        near[..., b_neg] += far[..., 0]
        near[..., b_pos] += far[..., 1]
        rows.append(near)
    return torch.stack(rows, 2).sum((0, 2)).t()


@pytest.mark.parametrize("tn", (64, 32, 16))
def test_demb_by_float32_tiles_equals_plain(tn):
    """At a T5 shape with far tiles on both sides (max_distance 24): the
    decomposition within the demb limits of the plain version at every
    float32 tile width, and a plan one tile too near outside them."""
    B, H, S, D = 2, 3, 333, 32
    q, k, v, do, mask = flash_inputs(B, H, H, S, D, True, device="cpu",
                                     dtype=torch.float32)
    t5 = T5Bias(t5_table(H, 16, device="cpu"), True, 16, 24)
    args = (D ** -0.5, False, None)
    out, lse = flash_fwd_plain(q, k, v, mask, *args, t5)
    _, ds = _dscores(q, k, v, mask, out, lse, do, *args, t5)
    want = flash_demb_plain(q, k, v, mask, out, lse, do, *args, t5)
    limit = flash_demb_limits(q, k, v, mask, lse, do, out, *args, t5)
    assert flash_excess(kernel_demb(ds, t5, tn), want, limit) <= 1.0
    neg, pos, b_neg, b_pos = t5.far_tiles(S, S)
    too_near = (neg + 64, pos - 64, b_neg, b_pos)
    assert flash_excess(kernel_demb(ds, t5, tn, too_near), want,
                        limit) > 1.0


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
