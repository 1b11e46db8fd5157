# Copy of pasero_tpu/tasks/language_modeling.py, verbatim.
"""Language modeling task (pasero/tasks/language_modeling.py).

Monolingual corpora, optional lang/domain tags, decoder-only models. Inputs at
inference are prompts; preprocessing produces a decoder_input whose leading
tags (+BOS) form the prompt mask.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Any, Optional

import numpy as np

from ..config import PreprocessingConfig, register_task
from ..config.tasks import LanguageModelingTaskConfig
from ..preprocessing import (TextPreprocessor, get_domain_tag, get_lang_code,
                             split_tags)
from .task import Corpus, InferenceCorpus, Task

logger = logging.getLogger("task")


class MonolingualCorpus(Corpus):
    def __init__(self, path: str, lang: Optional[str] = None,
                 tags: Optional[list] = None, **kwargs):
        super().__init__(paths=[path], langs=[lang] if lang else None, **kwargs)
        self.tags = tags

    @property
    def lang(self):
        return self.langs[0]

    @property
    def meta(self) -> dict:
        return {"corpus_id": self.corpus_id, "domain": self.domain,
                "lang": self.lang, "tags": self.tags}

    def tuple_to_dict(self, line_tuple: tuple) -> dict:
        (target,) = line_tuple
        return {"target": target, "meta": self.meta}


class InferenceMonolingualCorpus(InferenceCorpus, MonolingualCorpus):
    def __init__(self, input_path: Optional[str], lang: Optional[str] = None,
                 ref_path: Optional[str] = None, output_path: Optional[str] = None,
                 **kwargs):
        MonolingualCorpus.__init__(self, input_path, lang=lang, **kwargs)
        self.input_path = input_path
        self.ref_path = ref_path
        self.output_path = output_path


@register_task("language_modeling")
class LanguageModelingTask(Task):
    cfg: LanguageModelingTaskConfig

    def __init__(self, data_dir: str, cfg: LanguageModelingTaskConfig):
        super().__init__(data_dir, cfg)
        pp_cfg = PreprocessingConfig(
            **{k: getattr(cfg, k) for k in PreprocessingConfig._fields})
        self.tgt_preprocessor = TextPreprocessor(pp_cfg, data_dir)
        self.langs = set(cfg.langs or [])
        self.default_lang = cfg.langs[0] if cfg.langs else None
        self.domains = set(cfg.domains or [])
        self.check_tags()

    @property
    def preprocessor(self):
        return self.tgt_preprocessor

    @property
    def preprocessors(self):
        return {"target": self.tgt_preprocessor}

    @property
    def max_len(self):
        return self.cfg.max_len

    @property
    def encoder_num_embeddings(self) -> int:
        return 0

    @property
    def decoder_num_embeddings(self) -> int:
        return self.tgt_preprocessor.num_symbols

    def check_tags(self) -> None:
        d = self.tgt_preprocessor.dictionary
        if self.cfg.lang_code:
            for lang in self.langs:
                assert get_lang_code(lang) in d, f"{get_lang_code(lang)} is OOV"
        if self.cfg.domain_tag:
            for domain in self.domains:
                assert get_domain_tag(domain) in d, f"{get_domain_tag(domain)} is OOV"

    def register_corpora(self, *corpora) -> None:
        for corpus in corpora:
            meta = corpus.meta
            if meta.get("lang"):
                self.langs.add(meta["lang"])
            if meta.get("domain"):
                self.domains.add(meta["domain"])
        self.check_tags()

    def make_meta(self, lang=None, domain=None, tags=None, corpus_id=None,
                  **kwargs) -> dict:
        return {"lang": lang or self.default_lang, "domain": domain,
                "tags": tags, "corpus_id": corpus_id}

    def check_meta(self, meta: dict) -> None:
        if meta.get("lang") is not None and self.langs:
            assert meta["lang"] in self.langs, "language not covered by the model"

    def get_langs_or_domains(self, key: str) -> set:
        if key in ("lang", "source_lang", "target_lang"):
            return self.langs
        if key == "domain":
            return self.domains
        raise NotImplementedError(key)

    @property
    def task_info(self) -> dict:
        return {**super().task_info, "langs": sorted(self.langs),
                "default_lang": self.default_lang, "domains": sorted(self.domains)}

    @property
    def inference_options(self) -> dict:
        options = dict(self.tgt_preprocessor.inference_options)
        for name in ("lang_code", "domain_tag", "tags", "max_len"):
            value = getattr(self.cfg, name)
            if value:
                options[name] = value
        if self.langs:
            options["langs"] = sorted(self.langs)
        return options

    def get_tags(self, meta: dict) -> list:
        tags = list(meta.get("tags") or self.cfg.tags or [])
        if self.cfg.lang_code:
            assert meta.get("lang"), "missing language information"
            tags.append(get_lang_code(meta["lang"]))
        if self.cfg.domain_tag:
            tags.append(get_domain_tag(meta.get("domain")))
        return [t for t in tags if t]

    def input_to_sample(self, input: Any, meta: dict = {}) -> dict:
        # inference inputs are prompts to continue
        return {"prompt": input, "meta": meta}

    def get_reference(self, sample: dict):
        return sample.get("target")

    def should_skip(self, length: int) -> bool:
        return bool(self.max_len and length > self.max_len)

    def preprocess(self, sample: dict, truncate: bool = False,
                   tokenize: bool = True, append_eos: bool = False) -> dict:
        meta = sample.get("meta") or {}
        cutoff = self.max_len if truncate else None

        if "prompt" in sample and "target" not in sample:
            # inference: the prompt is teacher-forced, nothing is a training target
            prompt = sample["prompt"]
            *tags, prompt = split_tags(prompt)
            if tokenize:
                tags = tags + self.get_tags(meta)
            tokens = list(tags) + (self.tgt_preprocessor.tokenize(prompt)
                                   if tokenize else prompt.split())
            ids = self.tgt_preprocessor.binarize(
                tokens, max_len=cutoff, prepend_bos=self.prepend_bos,
                append_eos=False, truncate_left=True)
            return {"decoder_input": ids,
                    "prompt_mask": np.ones_like(ids, dtype=bool),
                    "emojis": [], "meta": meta}

        target = sample["target"]
        *tags, target = split_tags(target)
        if tokenize:
            tags = tags + self.get_tags(meta)
        prompt_len = len(tags)
        tokens = list(tags) + (self.tgt_preprocessor.tokenize(target)
                               if tokenize else target.split())
        ids = self.tgt_preprocessor.binarize(
            tokens, max_len=cutoff, prepend_bos=self.prepend_bos,
            append_eos=append_eos)
        if self.should_skip(len(ids)) and not truncate:
            return {}
        prompt_mask = np.zeros_like(ids, dtype=bool)
        prompt_mask[:prompt_len + int(self.prepend_bos)] = True
        return {"decoder_input": ids, "prompt_mask": prompt_mask,
                "emojis": [], "meta": meta}

    # -- corpora -------------------------------------------------------------
    @classmethod
    def _get_corpora(cls, data_dir: str, langs, corpus_definition: dict) -> list:
        corpora: dict[str, MonolingualCorpus] = {}
        domain = corpus_definition.get("domain")
        multiplier = corpus_definition.get("multiplier", 1)
        probability = corpus_definition.get("probability")
        early_stopping = corpus_definition.get("early_stopping", True)
        langs = corpus_definition.get("langs", langs) or [None]
        tags = corpus_definition.get("tags")
        paths = corpus_definition.get("paths")
        assert isinstance(paths, list), "corpus definition needs a list of paths"

        for path in paths:
            for lang in langs:
                candidates = []
                for root in (data_dir, "."):
                    p = path.format(lang=lang) if lang else path
                    p = os.path.join(root, p)
                    if lang and not os.path.exists(p):
                        p = p.removesuffix(f".{lang}") + f".{lang}"
                    candidates.append(MonolingualCorpus(
                        p, lang=lang, tags=tags, domain=domain,
                        multiplier=multiplier, probability=probability,
                        early_stopping=early_stopping))
                corpus = next((c for c in candidates if c.exists()), None)
                if corpus is None:
                    if corpus_definition.get("flexible"):
                        continue
                    raise FileNotFoundError(
                        f"corpus {candidates[0].paths} does not exist")
                corpora.setdefault(corpus.corpus_id, corpus)
        return list(corpora.values())

    @classmethod
    def get_train_corpora(cls, cfg, data_dir: str, corpus_definitions) -> list:
        out = []
        for definition in corpus_definitions:
            out += cls._get_corpora(data_dir, cfg.langs, definition)
        return out

    @classmethod
    def get_valid_corpora(cls, cfg, data_dir: str, corpus_definitions) -> list:
        out = []
        for definition in corpus_definitions:
            out += cls._get_corpora(data_dir, cfg.valid_langs or cfg.langs,
                                    definition)
        return out

    @classmethod
    def get_inference_corpora(cls, cfg, input_paths=None, output_paths=None,
                              ref_paths=None, corpus_prefix=None) -> list:
        corpora = []
        input_paths = input_paths or [None]
        output_paths = output_paths or [None] * len(input_paths)
        ref_paths = ref_paths or [None] * len(input_paths)
        for src, out, ref in itertools.zip_longest(input_paths, output_paths,
                                                   ref_paths):
            lang = cfg.langs[0] if cfg.langs else None
            if src and "." in os.path.basename(src):
                ext = src.rsplit(".", 1)[-1]
                if 2 <= len(ext) <= 3 and ext.isalpha():
                    lang = lang or ext
            corpora.append(InferenceMonolingualCorpus(
                src, lang=lang, ref_path=ref, output_path=out))
        return corpora
