# Copy of pasero_tpu/tasks/translation.py, verbatim.
"""Machine translation task (pasero/tasks/translation.py).

Source/target preprocessors (target-side option overrides, no target noise),
language-pair management with cartesian products and bidirectional corpora,
tagging (--lang-code/--source-lang-code/--target-lang-code/--domain-tag),
copy placeholders for matched OOVs, length-ratio filters, and decoder-only
concatenation with a prompt mask over the source.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Any, Optional

import numpy as np
import regex

from ..config import PreprocessingConfig, register_task
from ..config.common import NoiseConfig
from ..config.tasks import TranslationTaskConfig
from ..preprocessing import (TextPreprocessor, get_domain_tag, get_lang_code,
                             split_tags)
from ..tokenizers import copy_tag
from .task import Corpus, InferenceCorpus, Task

logger = logging.getLogger("task")


def _defined(x, default):
    return default if x is None else x


class ParallelCorpus(Corpus):
    def __init__(self, source_path: str, target_path: Optional[str],
                 source_lang: str, target_lang: str,
                 source_tags: Optional[list] = None,
                 target_tags: Optional[list] = None, **kwargs):
        super().__init__(paths=[source_path, target_path],
                         langs=[source_lang, target_lang], **kwargs)
        self.source_tags = source_tags
        self.target_tags = target_tags

    source_path = property(lambda self: self.paths[0])
    target_path = property(lambda self: self.paths[1])
    source_lang = property(lambda self: self.langs[0])
    target_lang = property(lambda self: self.langs[1])

    @classmethod
    def infer_domain(cls, path: str, langs: list) -> str:
        name = os.path.basename(path)
        for lang in langs:
            name = name.removesuffix(f".{lang}")
        a, b = langs
        return name.removesuffix(f".{a}-{b}").removesuffix(f".{b}-{a}")

    @property
    def corpus_id(self) -> str:
        suffix = "." + "-".join(self.langs)
        if not self.paths[0]:
            return f"stdin{suffix}"
        name = os.path.basename(self.paths[0])
        for lang in self.langs:
            name = name.removesuffix(f".{lang}")
        return name.removesuffix(suffix) + suffix

    @property
    def meta(self) -> dict:
        return {
            "corpus_id": self.corpus_id,
            "domain": self.domain,
            "source_lang": self.source_lang,
            "target_lang": self.target_lang,
            "source_tags": self.source_tags,
            "target_tags": self.target_tags,
        }

    def tuple_to_dict(self, line_tuple: tuple) -> dict:
        source, target = line_tuple
        return {"source": source, "target": target, "meta": self.meta}


class InferenceParallelCorpus(InferenceCorpus, ParallelCorpus):
    def __init__(self, source_path: Optional[str], source_lang: str,
                 target_lang: str, ref_path: Optional[str] = None,
                 output_path: Optional[str] = None, **kwargs):
        ParallelCorpus.__init__(self, source_path, ref_path,
                                source_lang, target_lang, **kwargs)
        self.input_path = source_path
        self.output_path = output_path

    @property
    def ref_path(self):
        return self.paths[1]


@register_task("translation")
class TranslationTask(Task):
    cfg: TranslationTaskConfig

    def __init__(self, data_dir: str, cfg: TranslationTaskConfig):
        super().__init__(data_dir, cfg)
        src_cfg = PreprocessingConfig(
            **{k: getattr(cfg, k) for k in PreprocessingConfig._fields})
        self.src_preprocessor = TextPreprocessor(src_cfg, data_dir)

        tgt_cfg = PreprocessingConfig(
            **{k: getattr(cfg, k) for k in PreprocessingConfig._fields})
        for key in list(PreprocessingConfig._fields):
            tgt_val = getattr(cfg, f"target_{key}", None)
            if tgt_val is not None:
                setattr(tgt_cfg, key, tgt_val)
        for key, value in NoiseConfig().as_dict().items():  # no target-side noise
            setattr(tgt_cfg, key, value)
        self.tgt_preprocessor = TextPreprocessor(tgt_cfg, data_dir)

        self.freeze_encoder_embed_mask = None
        if cfg.freeze_source_embed_regex:
            mask = np.array([bool(regex.match(cfg.freeze_source_embed_regex, t))
                             for t in self.src_preprocessor.dictionary])
            self.freeze_encoder_embed_mask = mask
            logger.info(f"{mask.sum()}/{len(mask)} source embeddings frozen")

        self.min_len_ratio = cfg.min_len_ratio
        self.max_len_ratio = cfg.max_len_ratio

        self.source_langs: set = set()
        self.target_langs: set = set()
        if cfg.lang_pairs:
            for pair in cfg.lang_pairs:
                src, tgt = pair.split("-")
                self.source_langs.add(src)
                self.target_langs.add(tgt)
        elif cfg.source_langs and cfg.target_langs:
            self.source_langs.update(cfg.source_langs)
            self.target_langs.update(cfg.target_langs)
        self.default_source_lang = cfg.source_lang
        self.default_target_lang = cfg.target_lang
        self.domains = set(cfg.domains or [])
        self.check_tags()

    # -- properties ---------------------------------------------------------
    @property
    def max_source_len(self):
        return self.cfg.max_source_len

    @property
    def max_target_len(self):
        return self.cfg.max_target_len

    @property
    def preprocessor(self):
        return self.tgt_preprocessor

    @property
    def preprocessors(self):
        return {"source": self.src_preprocessor, "target": self.tgt_preprocessor}

    @property
    def encoder_num_embeddings(self) -> int:
        return 0 if self.model_type == "decoder" else self.src_preprocessor.num_symbols

    @property
    def decoder_num_embeddings(self) -> int:
        return self.tgt_preprocessor.num_symbols

    # -- lang/domain management ---------------------------------------------
    def register_corpora(self, *corpora) -> None:
        for corpus in corpora:
            meta = corpus.meta
            self.source_langs.add(meta["source_lang"])
            self.target_langs.add(meta["target_lang"])
            if meta.get("domain"):
                self.domains.add(meta["domain"])
        self.check_tags()

    def make_meta(self, source_lang=None, target_lang=None, domain=None,
                  source_tags=None, target_tags=None, corpus_id=None) -> dict:
        return {"source_lang": source_lang or self.default_source_lang,
                "target_lang": target_lang or self.default_target_lang,
                "domain": domain, "source_tags": source_tags,
                "target_tags": target_tags, "corpus_id": corpus_id}

    def check_meta(self, meta: dict) -> None:
        if meta.get("source_lang") is not None and self.source_langs:
            assert meta["source_lang"] in self.source_langs, \
                "this source language is not covered by the model"
        if meta.get("target_lang") is not None and self.target_langs:
            assert meta["target_lang"] in self.target_langs, \
                "this target language is not covered by the model"

    def get_langs_or_domains(self, key: str) -> set:
        return {"source_lang": self.source_langs, "target_lang": self.target_langs,
                "domain": self.domains,
                "lang": self.source_langs | self.target_langs}[key]

    def check_tags(self) -> None:
        src_dict = self.src_preprocessor.dictionary
        tgt_dict = self.tgt_preprocessor.dictionary
        if self.cfg.domain_tag:
            for d in self.domains:
                assert get_domain_tag(d) in src_dict, f"{get_domain_tag(d)} is OOV"
        if self.cfg.source_lang_code:
            for lang in self.source_langs:
                assert get_lang_code(lang) in src_dict, f"{get_lang_code(lang)} is OOV"
        if self.cfg.lang_code:
            for lang in self.target_langs:
                assert get_lang_code(lang) in src_dict, f"{get_lang_code(lang)} is OOV"
        if self.cfg.target_lang_code:
            for lang in self.target_langs:
                assert get_lang_code(lang) in tgt_dict, f"{get_lang_code(lang)} is OOV"

    @property
    def task_info(self) -> dict:
        return {**super().task_info,
                "source_langs": sorted(self.source_langs),
                "target_langs": sorted(self.target_langs),
                "default_source_lang": self.default_source_lang,
                "default_target_lang": self.default_target_lang,
                "domains": sorted(self.domains)}

    @property
    def inference_options(self) -> dict:
        options = dict(self.src_preprocessor.inference_options)
        for name, value in self.tgt_preprocessor.inference_options.items():
            if options.get(name) != value:
                options[f"target_{name}"] = value
        for name in ("lang_code", "source_lang_code", "target_lang_code",
                     "domain_tag", "max_source_len", "max_target_len",
                     "source_tags", "target_tags"):
            value = getattr(self.cfg, name)
            if value:
                options[name] = value
        options["source_langs"] = sorted(self.source_langs)
        options["target_langs"] = sorted(self.target_langs)
        return options

    # -- tagging ------------------------------------------------------------
    def get_source_tags(self, meta: dict) -> list:
        tags = list(meta.get("source_tags") or self.cfg.source_tags or [])
        if self.cfg.lang_code:
            assert meta.get("target_lang"), "missing target language"
            tags.append(get_lang_code(meta["target_lang"]))
        if self.cfg.source_lang_code:
            assert meta.get("source_lang"), "missing source language"
            tags.append(get_lang_code(meta["source_lang"]))
        if self.cfg.domain_tag:
            tags.append(get_domain_tag(meta.get("domain")))
        return [t for t in tags if t]

    def get_target_tags(self, meta: dict) -> list:
        tags = list(meta.get("target_tags") or self.cfg.target_tags or [])
        if self.cfg.target_lang_code:
            assert meta.get("target_lang"), "missing target language"
            tags.append(get_lang_code(meta["target_lang"]))
        return [t for t in tags if t]

    # -- preprocessing -------------------------------------------------------
    def should_skip(self, source_len: int, target_len: int) -> bool:
        ratio = source_len / max(1, target_len)
        return bool(
            source_len == 0
            or (self.max_source_len and source_len > self.max_source_len)
            or (self.max_target_len and target_len > self.max_target_len)
            or (self.min_len_ratio and ratio < self.min_len_ratio)
            or (self.max_len_ratio and ratio > self.max_len_ratio))

    def copy_placeholder(self, source_tok: list, target_tok: list):
        """Replace OOVs with matching src/tgt counts by a copy token; drop
        single-char OOVs with mismatched counts (translation.py:330-341)."""
        src_counts, src_oov = self.src_preprocessor.get_oov(source_tok)
        tgt_counts, tgt_oov = self.tgt_preprocessor.get_oov(target_tok)
        to_copy = {w for w in src_oov | tgt_oov if src_counts[w] == tgt_counts[w]}
        to_del = {w for w in src_oov | tgt_oov
                  if len(w) == 1 and src_counts[w] != tgt_counts[w]}
        if to_copy or to_del:
            source_tok = [copy_tag if w in to_copy else w
                          for w in source_tok if w not in to_del]
            target_tok = [copy_tag if w in to_copy else w
                          for w in target_tok if w not in to_del]
        return source_tok, target_tok

    def input_to_sample(self, input: str, meta: dict = {}) -> dict:
        source, *target = input.rsplit("|||", maxsplit=1)
        return {"source": source, "target": target[0] if target else None,
                "meta": meta}

    def get_reference(self, sample: dict):
        return sample.get("target")

    def preprocess(self, sample: dict, truncate: bool = False,
                   tokenize: bool = True, append_eos: bool = False) -> dict:
        """text pair -> binarized encoder/decoder inputs + prompt mask
        (translation.py:405-534)."""
        source = sample.get("source")
        target = sample.get("target")
        meta = sample.get("meta") or {}

        source_cutoff = self.max_source_len if truncate else None
        target_cutoff = self.max_target_len if truncate else None

        *src_tags, source = split_tags(source)
        if target is None:
            tgt_tags = []
        else:
            *tgt_tags, target = split_tags(target)
        if tokenize:
            src_tags = src_tags + self.get_source_tags(meta)
            tgt_tags = tgt_tags + self.get_target_tags(meta)
        prompt_len = len(tgt_tags)

        emojis = []
        if self.cfg.escape_emojis and not self.training:
            source, emojis = self.src_preprocessor.escape_emojis(source)

        source_tok = list(src_tags) + (self.src_preprocessor.tokenize(source)
                                       if tokenize else source.split())
        target_tok = list(tgt_tags)
        if target:
            target_tok += (self.tgt_preprocessor.tokenize(target) if tokenize
                           else target.split())
        if self.cfg.copy_placeholder and self.training:
            source_tok, target_tok = self.copy_placeholder(source_tok, target_tok)

        if self.model_type == "decoder":
            source_bin = self.src_preprocessor.binarize(
                source_tok, max_len=source_cutoff, prepend_bos=self.prepend_bos,
                append_eos=True)  # EOS separates source and target
            if target_cutoff is not None:
                target_cutoff -= len(source_bin)
            target_bin = self.tgt_preprocessor.binarize(
                target_tok, max_len=target_cutoff, append_eos=append_eos)
            prompt_mask = np.concatenate([
                np.ones_like(source_bin, dtype=bool),
                np.zeros_like(target_bin, dtype=bool)])
            prompt_mask[len(source_bin):len(source_bin) + prompt_len] = True
            decoder_input = np.concatenate([source_bin, target_bin])
            if self.should_skip(len(source_bin), len(decoder_input)):
                return {}
            return {"decoder_input": decoder_input, "prompt_mask": prompt_mask,
                    "emojis": emojis, "meta": meta}

        encoder_input = self.src_preprocessor.binarize(
            source_tok, max_len=source_cutoff, append_eos=True)
        decoder_input = self.tgt_preprocessor.binarize(
            target_tok, max_len=target_cutoff, prepend_bos=self.prepend_bos,
            append_eos=append_eos)
        prompt_mask = np.zeros_like(decoder_input, dtype=bool)
        prompt_mask[:prompt_len + int(self.prepend_bos)] = True
        if self.should_skip(len(encoder_input), len(decoder_input)):
            return {}
        return {"encoder_input": encoder_input, "decoder_input": decoder_input,
                "prompt_mask": prompt_mask, "emojis": emojis, "meta": meta}

    # -- corpus resolution ---------------------------------------------------
    @classmethod
    def _get_corpus(cls, *args, **kwargs) -> ParallelCorpus:
        return ParallelCorpus(*args, **kwargs)

    @classmethod
    def _get_corpora(cls, data_dir: str, source_langs, target_langs, lang_pairs,
                     corpus_definition: dict, allow_monolingual: bool = False,
                     source_tags=None, target_tags=None) -> list:
        """Expand a corpus definition into ParallelCorpus objects: cartesian
        products, {src}/{tgt}/{pair} placeholders, reverse-pair fallback,
        per-corpus attributes (translation.py:559-683)."""
        corpora: dict[str, ParallelCorpus] = {}
        bidir = (not source_langs and not target_langs and not lang_pairs
                 and corpus_definition.get("bidir"))
        domain = corpus_definition.get("domain")
        multiplier = corpus_definition.get("multiplier", 1)
        probability = corpus_definition.get("probability")
        early_stopping = corpus_definition.get("early_stopping", True)
        source_langs = corpus_definition.get("source_langs", source_langs) or []
        target_langs = corpus_definition.get("target_langs", target_langs) or []
        lang_pairs = corpus_definition.get("lang_pairs", lang_pairs) or []
        flexible = corpus_definition.get("flexible")
        source_tags = corpus_definition.get("source_tags", source_tags)
        target_tags = corpus_definition.get("target_tags", target_tags)
        paths = corpus_definition.get("paths")
        source_paths = corpus_definition.get("source_paths") or paths
        target_paths = corpus_definition.get("target_paths") or paths
        assert isinstance(source_paths, list) and isinstance(target_paths, list), \
            "corpus definition needs a list of paths"

        if lang_pairs:
            pairs = [tuple(p.split("-")) for p in lang_pairs]
        elif source_langs and target_langs:
            pairs = [(s, t) for s, t in itertools.product(source_langs, target_langs)
                     if allow_monolingual or s != t]
        else:
            pairs = []
        assert pairs, "no language pair is defined"
        if bidir:
            pairs += [(t, s) for s, t in pairs]
        pairs = list(dict.fromkeys(pairs))

        for source_path, target_path in zip(source_paths, target_paths):
            for source_lang, target_lang in pairs:
                candidates = []
                for pair_str in (f"{source_lang}-{target_lang}",
                                 f"{target_lang}-{source_lang}"):
                    for root in (data_dir, "."):
                        src = source_path.format(src=source_lang, tgt=target_lang,
                                                 pair=pair_str)
                        tgt = target_path.format(src=source_lang, tgt=target_lang,
                                                 pair=pair_str)
                        src = os.path.join(root, src)
                        tgt = os.path.join(root, tgt)
                        if not (len(pairs) == 1 and os.path.exists(src)
                                and os.path.exists(tgt)):
                            src = src.removesuffix(f".{source_lang}") + f".{source_lang}"
                            tgt = tgt.removesuffix(f".{target_lang}") + f".{target_lang}"
                        candidates.append(cls._get_corpus(
                            src, tgt, source_lang=source_lang,
                            target_lang=target_lang, source_tags=source_tags,
                            target_tags=target_tags,
                            domain=_defined(domain, ParallelCorpus.infer_domain(
                                src, [source_lang, target_lang])),
                            multiplier=multiplier, probability=probability,
                            early_stopping=early_stopping))
                corpus = next((c for c in candidates if c.exists()), None)
                if corpus is None:
                    if flexible:
                        continue
                    raise FileNotFoundError(
                        f"corpus ({', '.join(map(str, candidates[0].paths))}) "
                        f"does not exist")
                corpora.setdefault(corpus.corpus_id, corpus)

        corpus_list = list(corpora.values())
        for corpus in corpus_list:
            if corpus.probability:
                corpus.probability /= len(corpus_list)
        return corpus_list

    @classmethod
    def get_train_corpora(cls, cfg, data_dir: str, corpus_definitions) -> list:
        corpora = []
        for definition in corpus_definitions:
            corpora += cls._get_corpora(
                data_dir, cfg.source_langs, cfg.target_langs, cfg.lang_pairs,
                definition, cfg.allow_monolingual,
                source_tags=cfg.source_tags, target_tags=cfg.target_tags)
        return corpora

    @classmethod
    def get_valid_corpora(cls, cfg, data_dir: str, corpus_definitions) -> list:
        corpora = []
        for definition in corpus_definitions:
            corpora += cls._get_corpora(
                data_dir,
                cfg.valid_source_langs or cfg.source_langs,
                cfg.valid_target_langs or cfg.target_langs,
                cfg.valid_lang_pairs or cfg.lang_pairs,
                definition, cfg.allow_monolingual,
                source_tags=cfg.source_tags, target_tags=cfg.target_tags)
        return corpora

    @classmethod
    def get_inference_corpora(cls, cfg, input_paths=None, output_paths=None,
                              ref_paths=None, corpus_prefix=None) -> list:
        """Build inference corpora, inferring languages from file extensions or
        expanding a corpus prefix over the configured language pairs
        (translation.py:751-874)."""
        corpora = []
        if corpus_prefix is not None:
            pairs = ([tuple(p.split("-")) for p in cfg.lang_pairs]
                     if cfg.lang_pairs else
                     [(s, t) for s, t in itertools.product(
                         cfg.source_langs or [], cfg.target_langs or [])
                      if cfg.allow_monolingual or s != t])
            assert pairs, "no language pair to evaluate"
            for src_lang, tgt_lang in pairs:
                pair = f"{src_lang}-{tgt_lang}"
                prefix = (corpus_prefix.format(src=src_lang, tgt=tgt_lang,
                                               pair=pair, lang=tgt_lang))
                src = prefix.removesuffix(f".{src_lang}") + f".{src_lang}"
                ref = prefix.removesuffix(f".{src_lang}") + f".{tgt_lang}"
                out = None
                if output_paths:
                    out = output_paths[0].format(src=src_lang, tgt=tgt_lang,
                                                 pair=pair, lang=tgt_lang)
                corpora.append(InferenceParallelCorpus(
                    src, source_lang=src_lang, target_lang=tgt_lang,
                    ref_path=ref, output_path=out))
            return corpora

        input_paths = input_paths or [None]
        ref_paths = ref_paths or [None] * len(input_paths)
        output_paths = output_paths or [None] * len(input_paths)
        for src, ref, out in itertools.zip_longest(input_paths, ref_paths,
                                                   output_paths):
            src_lang = cfg.source_lang
            tgt_lang = cfg.target_lang
            if src and "." in os.path.basename(src):
                ext = src.rsplit(".", 1)[-1]
                if 2 <= len(ext) <= 3 and ext.isalpha():
                    src_lang = src_lang or ext
            if ref and "." in os.path.basename(ref):
                ext = ref.rsplit(".", 1)[-1]
                if 2 <= len(ext) <= 3 and ext.isalpha():
                    tgt_lang = tgt_lang or ext
            assert src_lang and tgt_lang, \
                "could not infer the language pair; use -s/-t"
            if src and not os.path.exists(src):
                formatted = TranslationTaskConfig.format_path(src, src_lang, tgt_lang)
                src = formatted if os.path.exists(formatted) else src
            corpora.append(InferenceParallelCorpus(
                src, source_lang=src_lang, target_lang=tgt_lang,
                ref_path=ref, output_path=out))
        return corpora

    def postprocess_hypothesis(self, sample: dict, hypothesis: dict) -> None:
        if self.cfg.escape_emojis and sample.get("emojis"):
            hypothesis["detok"] = self.tgt_preprocessor.deescape_emojis(
                hypothesis["detok"], sample["emojis"])
