"""Decoding: greedy, sampling, speculative greedy and beam search over a
fixed-size KV cache.

PyTorch counterpart of pasero_tpu/decoding/search.py. The JAX functions are
``lax.while_loop``s over fixed shapes; here the loop is a Python loop around
the same fixed-shape state, and its stop test is the one host read of each
step (of each chunk, for speculative decoding). As there:

- prompts are LEFT-aligned so all rows write the KV cache at the same slot;
- sampling applies temperature, repeat penalty, top-k and top-p as JAX's
  ``_apply_sampling_filters`` does; the draw comes from a ``torch.Generator``
  (the same distribution as JAX's, not the same bits);
- greedy paths may take the fused argmax head (``PASERO_FUSED_HEAD=1``):
  token and log-probability come from ``decode_step(head="argmax")`` and the
  (B, V) logits never exist;
- speculative greedy decoding verifies prompt-lookup drafts in one decoder
  call per chunk and rewinds the cache index past the rejected tail; its
  tokens are greedy decoding's;
- beam search keeps 2*beam candidates per step (fairseq-style EOS harvest),
  finalizes EOS hypotheses into a fixed (B, beam) buffer, normalizes scores
  by (len+1)^p, and falls back to the live beams where a row never finished;
- lineage beams (attention.lineage_attention) are the default: the cache is
  never reordered.

Selection stages over a few candidates use a stable descending sort, which
keeps ``lax.top_k``'s tie order (lowest index first).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import not_ported

NEG_INF = -1e9


def left_align(tokens: np.ndarray, mask: np.ndarray, pad_idx: int):
    """Right-padded prompt rows -> left-padded (right-aligned) rows."""
    tokens = np.asarray(tokens)
    mask = np.asarray(mask, dtype=bool)
    out_tokens = np.full_like(tokens, pad_idx)
    out_mask = np.zeros_like(mask)
    P = tokens.shape[1]
    for i in range(tokens.shape[0]):
        ids = tokens[i, mask[i]]
        if len(ids):
            out_tokens[i, P - len(ids):] = ids
            out_mask[i, P - len(ids):] = True
    return out_tokens, out_mask


def _stable_topk(x, k: int):
    """Top-k along the last axis with ``lax.top_k``'s order: values
    descending, equal values by increasing index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _penalize(logits, tokens_so_far, repeat_penalty: float):
    """Logits of tokens already generated divided by ``repeat_penalty``
    (multiplied where negative)."""
    if repeat_penalty == 1.0:
        return logits
    seen = torch.zeros_like(logits, dtype=torch.bool)
    seen.scatter_(1, tokens_so_far, True)
    penalized = torch.where(logits < 0, logits * repeat_penalty,
                            logits / repeat_penalty)
    return torch.where(seen, penalized, logits)


def _sampling_logits(logits, temperature: float, top_k: int, top_p: float):
    """The logits a sample is drawn from: divided by the temperature, NEG_INF
    below the k-th largest and outside the smallest set of tokens whose
    probability reaches top_p."""
    scaled = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff, NEG_INF, scaled)
    return scaled


def _apply_sampling_filters(logits, tokens_so_far, cfg_static,
                            generator=None):
    """temperature / repeat penalty / top-k / top-p -> token and its
    log-probability (pasero_tpu/decoding/search.py:46). logits (B, V)
    float32; tokens_so_far (B, T) ids; cfg_static (temperature, top_k, top_p,
    repeat_penalty, greedy); ``generator`` draws the sample."""
    temperature, top_k, top_p, repeat_penalty, greedy = cfg_static
    logprobs = torch.log_softmax(logits, dim=-1)
    logits = _penalize(logits, tokens_so_far, repeat_penalty)
    if greedy:
        token = logits.argmax(dim=-1)
    else:
        probs = torch.softmax(_sampling_logits(logits, temperature, top_k,
                                               top_p), dim=-1)
        token = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return token, logprobs.gather(1, token[:, None])[:, 0]


def _use_fused_head(model) -> bool:
    """JAX's rule (pasero_tpu/decoding/search.py:105): PASERO_FUSED_HEAD=1
    turns the fused argmax head on for a model that has one, anything else
    leaves it off."""
    if not getattr(model, "supports_fused_head", False):
        return False
    return os.environ.get("PASERO_FUSED_HEAD", "auto") == "1"


def _prompt_state(prompt, prompt_mask, max_new: int):
    """Positions of the left-padded prompt and the (B, P + max_new) validity
    of the cache slots."""
    B, P = prompt.shape
    prompt_len = prompt_mask.sum(dim=1)
    positions = (torch.arange(P, device=prompt.device)[None, :]
                 - (P - prompt_len)[:, None])
    pad_valid = torch.cat([prompt_mask, prompt_mask.new_ones(B, max_new)], 1)
    return prompt_len, positions, pad_valid


def _last_logits(logits):
    return logits[:, -1].float()


def sample_decode(model, prompt, prompt_mask, *, max_new: int, eos_idx: int,
                  pad_idx: int, encoder_out=None, encoder_mask=None,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                  repeat_penalty: float = 1.0, greedy: bool = True,
                  min_lengths=None, blacklist: tuple = (),
                  stop_sequences: tuple = (), generator=None):
    """Greedy / sampling generation (pasero_tpu/decoding/search.py:148).

    prompt: (B, P) LEFT-padded integer ids; prompt_mask: (B, P) bool;
    ``generator``: the ``torch.Generator`` of the sampling draws. Returns a
    dict with tokens (B, max_new), scores (B, max_new), lengths (B,) and
    model_calls (decoder calls made). Greedy decoding with no repeat penalty,
    blacklist or minimum lengths takes the fused argmax head where
    ``_use_fused_head`` says so.
    """
    B, P = prompt.shape
    device = prompt.device
    prompt_len, positions, pad_valid = _prompt_state(prompt, prompt_mask,
                                                     max_new)
    cfg_static = (temperature, top_k, top_p, repeat_penalty, greedy)
    fuse_head = (greedy and repeat_penalty == 1.0 and not blacklist
                 and min_lengths is None and _use_fused_head(model))
    head = "argmax" if fuse_head else "logits"

    def last(out):
        """(token, logprob) of the fused head, or the last logits."""
        if fuse_head:
            return out[0][:, -1], out[1][:, -1]
        return _last_logits(out)

    cache = model.make_cache(B, P + max_new)
    out = last(model.decode_step(
        prompt, cache, encoder_out=encoder_out, encoder_mask=encoder_mask,
        positions=positions, tgt_mask=torch.ones_like(prompt_mask),
        self_kv_mask=pad_valid, head=head))
    calls = 1
    blacklist_idx = (torch.tensor(list(blacklist), device=device)
                     if blacklist else None)
    min_len = is_eos = None
    if min_lengths is not None:      # then out holds logits (no fused head)
        min_len = torch.as_tensor(min_lengths, device=device)
        is_eos = torch.arange(out.shape[-1], device=device) == eos_idx
    stops = [torch.as_tensor(s, device=device) for s in stop_sequences]

    tokens_buf = torch.full((B, max_new), pad_idx, dtype=torch.long,
                            device=device)
    scores_buf = torch.zeros((B, max_new), device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    finish_step = torch.full((B,), max_new, dtype=torch.long, device=device)
    ones = torch.ones((B, 1), dtype=torch.bool, device=device)
    step = 0
    while step < max_new and not bool(finished.all()):
        if fuse_head:
            token, logprob = out        # precomputed by the fused head
        else:
            logits = out
            if blacklist_idx is not None:
                logits[:, blacklist_idx] = NEG_INF
            if min_len is not None:
                logits = logits.masked_fill(
                    (step < min_len)[:, None] & is_eos[None], NEG_INF)
            token, logprob = _apply_sampling_filters(logits, tokens_buf,
                                                     cfg_static, generator)
        token = torch.where(finished, pad_idx, token)
        logprob = torch.where(finished, 0.0, logprob)
        tokens_buf[:, step] = token
        scores_buf[:, step] = logprob
        hit_stop = torch.zeros_like(finished)
        for seq in stops:
            n = len(seq)
            if step + 1 >= n:
                hit_stop |= (tokens_buf[:, step + 1 - n:step + 1] == seq).all(1)
        now_finished = finished | (token == eos_idx) | hit_stop
        finish_step = torch.where(now_finished & ~finished, step + 1,
                                  finish_step)
        finished = now_finished
        out = last(model.decode_step(
            token[:, None], cache, encoder_mask=encoder_mask,
            positions=(prompt_len + step)[:, None], tgt_mask=ones,
            self_kv_mask=pad_valid, head=head))
        calls += 1
        step += 1

    lengths = finish_step.clamp(max=max_new)
    valid = torch.arange(max_new, device=device)[None] < lengths[:, None]
    return {"tokens": tokens_buf.masked_fill(~valid, pad_idx),
            "scores": scores_buf.masked_fill(~valid, 0.0),
            "lengths": lengths, "model_calls": calls}


def beam_search(model, prompt, prompt_mask, *, beam_size: int, max_new: int,
                eos_idx: int, pad_idx: int, encoder_out=None,
                encoder_mask=None, len_penalty: float = 1.0,
                min_lengths=None, blacklist: tuple = (),
                lineage: Optional[bool] = None):
    """fairseq-style beam search (pasero_tpu/decoding/search.py:349).

    prompt (B, P) LEFT-padded (forced tokens are teacher-forced for every
    beam). Returns tokens (B, beam, max_new), scores (B, beam) normalized,
    positional_scores (B, beam, max_new), lengths (B, beam) — hypotheses
    sorted best-first — and model_calls (decoder calls made).
    """
    B, P = prompt.shape
    K = beam_size
    device = prompt.device
    use_lineage = ((lineage is None or lineage) and K > 1
                   and getattr(model, "supports_beam_lineage", False))
    if not use_lineage and K > 1:
        raise not_ported("beam search with cache reordering (lineage=False)",
                         "A.6 decoding")

    def expand(x):
        return None if x is None else x.repeat_interleave(K, dim=0)

    prompt_k = expand(prompt)
    prompt_len_k, positions, pad_valid_k = _prompt_state(
        prompt_k, expand(prompt_mask), max_new)
    encoder_out_k = expand(encoder_out)
    encoder_mask_k = expand(encoder_mask)
    blacklist_idx = (torch.tensor(list(blacklist), device=device)
                     if blacklist else None)
    min_len_k = (torch.as_tensor(min_lengths, device=device)
                 .repeat_interleave(K) if min_lengths is not None else None)
    vocab_eos = None

    def select_candidates(scores, step: int):
        """Per-row top-2K candidates of the raw fp32 logits, then the
        log-softmax normalizer subtracted from the survivors only (a
        constant shift within a row leaves the top-2K indices unchanged)."""
        nonlocal vocab_eos
        lse = torch.logsumexp(scores, dim=-1, keepdim=True)
        if blacklist_idx is not None:
            scores[:, blacklist_idx] = NEG_INF
        if min_len_k is not None:
            if vocab_eos is None:
                vocab_eos = torch.arange(scores.shape[-1], device=device) \
                    == eos_idx
            scores = scores.masked_fill((step < min_len_k)[:, None]
                                        & vocab_eos[None], NEG_INF)
        vals, idx = torch.topk(scores, 2 * K, dim=-1)          # (B*K, 2K)
        vals = vals - lse
        if blacklist_idx is not None or min_len_k is not None:
            # masked tokens keep exactly NEG_INF (see the JAX function)
            vals = torch.where(vals < NEG_INF * 0.5, NEG_INF, vals)
        return vals, idx

    cache = model.make_cache(B * K, P + max_new)
    logits = model.decode_step(
        prompt_k, cache, encoder_out=encoder_out_k,
        encoder_mask=encoder_mask_k, positions=positions,
        tgt_mask=torch.ones_like(prompt_k, dtype=torch.bool),
        self_kv_mask=pad_valid_k)
    calls = 1
    sel_vals, row_idx = select_candidates(_last_logits(logits), 0)

    def norm(score, length):
        return score / ((length + 1.0) ** len_penalty)

    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.long, device=device)
    live_scores = torch.full((B, K), NEG_INF, **f32)
    live_scores[:, 0] = 0.0
    tokens_buf = torch.full((B, K, max_new), pad_idx, **i64)
    pos_scores_buf = torch.zeros((B, K, max_new), **f32)
    fin_scores = torch.full((B, K), NEG_INF, **f32)
    fin_tokens = torch.full((B, K, max_new), pad_idx, **i64)
    fin_pos_scores = torch.zeros((B, K, max_new), **f32)
    fin_lengths = torch.zeros((B, K), **i64)
    # lineage starts as identity: prompt rows are identical across beams
    own = torch.arange(K, **i64)[None, :, None]
    lineage_buf = own.expand(B, K, P + max_new).contiguous()
    ones = torch.ones((B * K, 1), dtype=torch.bool, device=device)
    rows = torch.arange(B, device=device)[:, None]

    step = 0
    while step < max_new:
        # stop when no live beam can beat the worst finalized hypothesis
        best_possible = norm(live_scores.max(dim=1).values, float(max_new))
        if not bool((best_possible > fin_scores.min(dim=1).values).any()):
            break
        row_scores = live_scores.reshape(B * K, 1) + sel_vals
        top_scores, pos = _stable_topk(row_scores.reshape(B, 2 * K * K),
                                       2 * K)                       # (B, 2K)
        beam_idx = pos // (2 * K)
        token_idx = row_idx.reshape(B, 2 * K * K).gather(1, pos)

        is_eos = token_idx == eos_idx
        # -- finalize EOS candidates into the fixed-size buffers ------------
        eos_norm = torch.where(is_eos, norm(top_scores, float(step + 1)),
                               NEG_INF)
        take_scores, take_idx = _stable_topk(
            torch.cat([fin_scores, eos_norm], dim=1), K)
        cand_tokens = tokens_buf[rows, beam_idx]                 # (B, 2K, T)
        cand_tokens[:, :, step] = torch.where(is_eos, token_idx, pad_idx)
        cand_pos = pos_scores_buf[rows, beam_idx]
        step_logprob = top_scores - live_scores.gather(1, beam_idx)
        cand_pos[:, :, step] = step_logprob
        cand_lengths = torch.full((B, 2 * K), step + 1, **i64)
        fin_scores = take_scores
        fin_tokens = torch.cat([fin_tokens, cand_tokens], 1)[rows, take_idx]
        fin_pos_scores = torch.cat([fin_pos_scores, cand_pos], 1)[rows,
                                                                  take_idx]
        fin_lengths = torch.cat([fin_lengths, cand_lengths], 1).gather(
            1, take_idx)

        # -- keep the best K non-EOS candidates as the live beams -----------
        live_scores, live_idx = _stable_topk(
            torch.where(is_eos, NEG_INF, top_scores), K)
        new_beam_idx = beam_idx.gather(1, live_idx)
        new_token = token_idx.gather(1, live_idx)
        tokens_buf = tokens_buf[rows, new_beam_idx]
        tokens_buf[:, :, step] = new_token
        pos_scores_buf = pos_scores_buf[rows, new_beam_idx]
        pos_scores_buf[:, :, step] = step_logprob.gather(1, live_idx)

        # logical beam k's history = its parent's; the KV row the next
        # model call writes at slot P+step belongs to beam k itself
        lineage_buf = lineage_buf[rows, new_beam_idx]
        lineage_buf[:, :, P + step] = own[:, :, 0]

        logits = model.decode_step(
            new_token.reshape(B * K, 1), cache, encoder_mask=encoder_mask_k,
            positions=(prompt_len_k + step)[:, None], tgt_mask=ones,
            self_kv_mask=pad_valid_k, beam_lineage=lineage_buf)
        calls += 1
        sel_vals, row_idx = select_candidates(_last_logits(logits), step + 1)
        step += 1

    # if some rows never produced EOS, fall back to the best live beams
    no_final = fin_scores <= NEG_INF / 2
    fin_scores = torch.where(no_final, norm(live_scores, float(max_new)),
                             fin_scores)
    fin_tokens = torch.where(no_final[..., None], tokens_buf, fin_tokens)
    fin_pos_scores = torch.where(no_final[..., None], pos_scores_buf,
                                 fin_pos_scores)
    fin_lengths = torch.where(no_final, max_new, fin_lengths)

    order = torch.sort(fin_scores, dim=1, descending=True, stable=True).indices
    return {"tokens": fin_tokens[rows, order],
            "scores": fin_scores.gather(1, order),
            "positional_scores": fin_pos_scores[rows, order],
            "lengths": fin_lengths.gather(1, order),
            "model_calls": calls}


# -- speculative greedy decoding (prompt-lookup drafts) ----------------------

def _lookup_draft(lookup, lookup_valid, last, prev, K: int):
    """Draft K tokens by n-gram matching against ``lookup`` (B, Ls)
    (pasero_tpu/decoding/search.py:596): the tokens that followed the most
    recent position j with lookup[j] == last, preferring bigram matches
    (lookup[j - 1] == prev); rows without a match draft ``last`` repeated."""
    B, Ls = lookup.shape
    match = (lookup == last[:, None]) & lookup_valid
    prev_ok = torch.cat([torch.ones_like(match[:, :1]),
                         lookup[:, :-1] == prev[:, None]], dim=1)
    bigram = match & prev_ok
    use = torch.where(bigram.any(dim=1, keepdim=True), bigram, match)
    j = Ls - 1 - use.flip(1).to(torch.uint8).argmax(dim=1)      # last True
    has = use.any(dim=1)
    idx = j[:, None] + 1 + torch.arange(K, device=lookup.device)[None]
    ok = has[:, None] & (idx < Ls)
    idx = idx.clamp(0, Ls - 1)
    ok &= lookup_valid.gather(1, idx)
    return torch.where(ok, lookup.gather(1, idx), last[:, None])


def _rewind_cache(cache, new_index: int) -> None:
    """Reset every self-attention cache's write index after a partially
    accepted chunk (pasero_tpu/decoding/search.py:620): the stale K/V past
    the index are masked out by the written-slot check and overwritten by the
    next chunk. The ALiBi step, JAX's ``bias_step``, is this index
    (``TransformerDecoder._alibi``), so it rewinds with it."""
    for self_cache, _ in cache:
        self_cache.index = new_index


def speculative_greedy_decode(model, prompt, prompt_mask, *, max_new: int,
                              eos_idx: int, pad_idx: int, encoder_out=None,
                              encoder_mask=None, lookup=None, lookup_mask=None,
                              draft_len: int = 6):
    """Greedy decoding with prompt-lookup speculation: exactly greedy's
    tokens (pasero_tpu/decoding/search.py:633).

    Each iteration verifies ``draft_len`` drafted tokens (n-gram continuations
    from ``lookup``, default the prompt, and the generated prefix) in one
    decoder call, accepts the longest batch-common correct prefix plus one
    bonus token, and rewinds the KV-cache index past the rest. The batch-common
    accepted length is one host read per chunk. The cache has
    ``P + max_new + draft_len + 1`` slots. Returns tokens, scores, lengths and
    model_calls as ``sample_decode``.
    """
    B, P = prompt.shape
    K = draft_len
    W = max_new + K + 1
    device = prompt.device
    prompt_len = prompt_mask.sum(dim=1)
    pad_valid = torch.cat([prompt_mask, prompt_mask.new_ones(B, W)], dim=1)
    if lookup is None:
        lookup, lookup_mask = prompt, prompt_mask
    if lookup_mask is None:
        lookup_mask = torch.ones(lookup.shape, dtype=torch.bool, device=device)
    positions0 = (torch.arange(P, device=device)[None, :]
                  - (P - prompt_len)[:, None])
    fuse_head = _use_fused_head(model)
    head = "argmax" if fuse_head else "logits"

    def greedy_of(out):
        """(greedy tokens, their log-probabilities) (B, T) of a call."""
        if fuse_head:
            return out
        logits = out.float()
        tokens = logits.argmax(dim=-1)
        logprobs = torch.log_softmax(logits, dim=-1)
        return tokens, logprobs.gather(-1, tokens[..., None])[..., 0]

    cache = model.make_cache(B, P + W)
    tok, lp = greedy_of(model.decode_step(
        prompt, cache, encoder_out=encoder_out, encoder_mask=encoder_mask,
        positions=positions0, tgt_mask=torch.ones_like(prompt_mask),
        self_kv_mask=pad_valid, head=head))
    last, lp0 = tok[:, -1], lp[:, -1]
    tokens_buf = torch.full((B, W), pad_idx, dtype=torch.long, device=device)
    scores_buf = torch.zeros((B, W), device=device)
    tokens_buf[:, 0] = last
    scores_buf[:, 0] = lp0
    finished = last == eos_idx
    prev = torch.where(prompt_len > 0, prompt[:, -1], pad_idx)
    cols = torch.arange(K + 1, device=device)[None]
    chunk_ones = torch.ones((B, K + 1), dtype=torch.bool, device=device)
    slots = torch.arange(W, device=device)[None]
    step, calls = 1, 1
    while step < max_new and not bool(finished.all()):
        full_lookup = torch.cat([lookup, tokens_buf], dim=1)
        full_valid = torch.cat([lookup_mask, (slots < step).expand(B, W)],
                               dim=1)
        draft = _lookup_draft(full_lookup, full_valid, last, prev, K)
        chunk = torch.cat([last[:, None], draft], dim=1)           # (B, K+1)
        positions = prompt_len[:, None] + step - 1 + cols
        greedy, greedy_lp = greedy_of(model.decode_step(
            chunk, cache, encoder_mask=encoder_mask, positions=positions,
            tgt_mask=chunk_ones, self_kv_mask=pad_valid, head=head))
        calls += 1
        hit = torch.cumprod((draft == greedy[:, :K]).long(), dim=1)
        accepted = torch.where(finished, K, hit.sum(dim=1))
        a_min = int(accepted.min())                     # the batch-common prefix
        # emitted = accepted drafts [0, a_min) + the greedy token at a_min
        draft_p = torch.nn.functional.pad(draft, (0, 1))
        emitted = torch.where(cols < a_min, draft_p, greedy[:, a_min:a_min + 1])
        emitted = torch.where(cols <= a_min, emitted, pad_idx)
        emitted = torch.where(finished[:, None], pad_idx, emitted)
        emit_lp = torch.where((cols <= a_min) & ~finished[:, None], greedy_lp,
                              0.0)
        tokens_buf[:, step:step + K + 1] = emitted
        scores_buf[:, step:step + K + 1] = emit_lp
        finished = finished | (emitted == eos_idx).any(dim=1)
        prev = emitted[:, a_min - 1] if a_min > 0 else last
        last = emitted[:, a_min]
        _rewind_cache(cache, P + step + a_min)
        step += a_min + 1

    tokens_buf = tokens_buf[:, :max_new]
    scores_buf = scores_buf[:, :max_new]
    is_eos = torch.cat([tokens_buf == eos_idx,
                        torch.ones((B, 1), dtype=torch.bool, device=device)], 1)
    lengths = (is_eos.to(torch.uint8).argmax(dim=1) + 1).clamp(max=max_new)
    valid = torch.arange(max_new, device=device)[None] < lengths[:, None]
    return {"tokens": tokens_buf.masked_fill(~valid, pad_idx),
            "scores": scores_buf.masked_fill(~valid, 0.0),
            "lengths": lengths, "model_calls": calls}
