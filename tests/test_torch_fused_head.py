"""The port's fused greedy head against pasero_tpu's Pallas kernels (in
interpret mode on the CPU), on the same inputs.

``fused_head_argmax`` with a float head (float32, and bfloat16 x with the
head rounded to bfloat16) and with an int8 QTensor head quantized from the
flax orientations JAX supports: a (vocab, embed) table quantized per row and
an (embed, vocab) kernel quantized per column, which the port stores as the
transposed, row-quantized (vocab, embed) weight. Tokens must be equal (the
lowest index wins a tie, also across the kernels' vocabulary blocks) and the
log-probabilities within 2e-4 (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_tpu.ops import fused_ce as jf
from pasero_tpu.ops import quantize as jq
from pasero_torch.ops import fused_ce as tf
from pasero_torch.ops import quantize as tq

LP_ATOL = 2e-4


def compare(x, jax_head, port_head, bf16=False):
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.tensor(np.asarray(xj, np.float32))
    if bf16:
        xt = xt.bfloat16()
    want_tok, want_lp = jf.fused_head_argmax(xj, jax_head)
    got_tok, got_lp = tf.fused_head_argmax(xt, port_head)
    assert got_tok.dtype == torch.int64 and got_lp.dtype == torch.float32
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               atol=LP_ATOL, rtol=0)


@pytest.mark.parametrize("N,E,V", [(8, 64, 1000), (48, 128, 333),
                                   (130, 32, 4097)])
@pytest.mark.parametrize("bf16", [False, True])
def test_float_head_matches_jax(N, E, V, bf16):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, E)).astype(np.float32)
    kernel = (rng.normal(size=(E, V)) * 0.05).astype(np.float32)
    compare(x, jnp.asarray(kernel), torch.from_numpy(kernel.T.copy()), bf16)


@pytest.mark.parametrize("orientation", ["row", "col"])
@pytest.mark.parametrize("bf16", [False, True])
def test_int8_head_matches_jax(orientation, bf16):
    rng = np.random.default_rng(6)
    E, V, N = 128, 1000, 24
    x = rng.normal(size=(N, E)).astype(np.float32)
    if orientation == "row":            # a tied (V, E) table
        table = rng.normal(size=(V, E)).astype(np.float32)
        jax_head = jq.quantize(jnp.asarray(table), axis=1)
        port_head = tq.quantize(torch.from_numpy(table))
    else:                               # an untied (E, V) flax kernel
        kernel = rng.normal(size=(E, V)).astype(np.float32)
        jax_head = jq.quantize(jnp.asarray(kernel), axis=0)
        port_head = tq.quantize(torch.from_numpy(kernel.T.copy()))
    before = (tf.fused_head_argmax.launches, tf.fused_head_argmax_q8.launches)
    compare(x, jax_head, port_head, bf16)
    # CPU tensors take the plain version: nothing is launched
    assert (tf.fused_head_argmax.launches,
            tf.fused_head_argmax_q8.launches) == before


def test_ties_go_to_the_lowest_index():
    """Equal maxima at columns 7 and 250 (in two different vocabulary blocks
    of the CUDA kernel): both packages pick 7."""
    x = np.ones((4, 16), np.float32)
    kernel = np.zeros((16, 300), np.float32)
    kernel[:, 7] = kernel[:, 250] = 1.0
    compare(x, jnp.asarray(kernel), torch.from_numpy(kernel.T.copy()))
    tok, _ = tf.fused_head_argmax(torch.from_numpy(x),
                                  torch.from_numpy(kernel.T.copy()))
    assert (tok == 7).all()


def test_fused_head_wrapper_refuses_what_it_does_not_take():
    """Off the CPU the wrappers launch or raise: a float32 x, an E that is
    not a multiple of 16, mismatched shapes and a device without a kernel
    raise before any launch."""
    w = torch.randn(50, 40)
    t = tq.quantize(w)
    counts = (tf.fused_head_argmax, tf.fused_head_argmax_q8)
    before = [fn.launches for fn in counts]
    with pytest.raises(TypeError):
        tf._head_cuda(torch.zeros(3, 40, device="meta"), w, None)
    with pytest.raises(ValueError):
        tf._head_cuda(torch.zeros(3, 40, dtype=torch.bfloat16, device="meta"),
                      w, None)
    with pytest.raises(ValueError):
        tf.fused_head_argmax(torch.zeros(3, 32), w)
    with pytest.raises(ValueError):
        tf.fused_head_argmax_q8(torch.zeros(3, 40, device="meta"), t)
    assert [fn.launches for fn in counts] == before
