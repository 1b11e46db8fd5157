"""Corpus evaluation / batch decoding CLI of the PyTorch port
(the counterpart of cli/decode.py, single device).

    python -m pasero_torch.cli.decode MODEL_DIR -i test.de -r test.en \
        --beam-size 5 [--device cpu]
    python -m pasero_torch.cli.decode LM_DIR -i prompts.txt \
        [--quantize int8] [--sampling --sampling-topk 10] [--speculative]
    python -m pasero_torch.cli.decode ST_DIR -i test.feats -r test.en

Resolves inference corpora from --input/--reference/--eval-corpus, decodes
each with the TextGenerator (an encoder-decoder or a decoder-only model;
beam search, greedy, sampling or speculative greedy search; int8 weights
with --quantize int8), and logs per-corpus and averaged metrics
(wps/bleu/chrf/...) and, at the end, the launch counts of the int8,
fused-head and mel kernels. A speech model (``--task speech_translation``)
reads a binary feature file (``NumpyFile``). ``--device`` defaults to the card; without one it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("decode")


def main(argv=None):
    from pasero_torch import not_ported
    from pasero_torch.config import DecodingCLIConfig, get_task_cls
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_q8)
    from pasero_torch.ops.mel import power_mel
    from pasero_torch.ops.quantize import int8_matmul

    cfg = DecodingCLIConfig(*(argv or []), strict=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(name)s | %(message)s")
    if cfg.teacher_forcing:
        raise not_ported("--teacher-forcing", "A.6 decoding")
    if cfg.moe_stats:
        raise not_ported("--moe-stats", "A.10 MoE, adapters and hybrid")

    task_cls = get_task_cls(cfg.task)
    corpora = task_cls.get_inference_corpora(
        cfg.task_cfg, input_paths=cfg.input, output_paths=cfg.output,
        ref_paths=cfg.reference, corpus_prefix=cfg.eval_corpus)

    generator = TextGenerator(cfg)
    metrics = cfg.metrics or []
    totals: dict = {}
    for corpus in corpora:
        results = generator.decode_corpus(
            corpus, buffer_size=cfg.buffer_size, max_lines=cfg.max_lines,
            verbose=cfg.verbose, quiet=cfg.quiet, continue_=cfg.continue_,
            metrics=metrics, beam_size=cfg.beam_size,
            max_output_len=cfg.max_output_len, sampling=cfg.sampling)
        line = " | ".join(f"{k} {round(v, 2) if isinstance(v, float) else v}"
                          for k, v in results.items())
        logger.info(f"{corpus.corpus_id} | {line}")
        for k, v in results.items():
            if isinstance(v, (int, float)):
                totals.setdefault(k, []).append(v)
    if len(corpora) > 1:
        avg = {k: round(sum(v) / len(v), 2) for k, v in totals.items()}
        logger.info("average | " + " | ".join(f"{k} {v}" for k, v in avg.items()))
    logger.info("launches | " + " | ".join(
        f"{fn.__name__} {fn.launches}" for fn in
        (int8_matmul, fused_head_argmax, fused_head_argmax_q8, power_mel)))


if __name__ == "__main__":
    main()
