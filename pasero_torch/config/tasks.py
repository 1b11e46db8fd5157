# Copy of pasero_tpu/config/tasks.py, verbatim.
"""Task-specific option groups (pasero/config.py:1871-2182)."""

from __future__ import annotations

from typing import Optional

from .core import argument
from .common import TaskConfig

TASK_CONFIG_REGISTRY: dict[str, type] = {}


def register_task_config(name: str):
    def wrapper(cls):
        TASK_CONFIG_REGISTRY[name] = cls
        return cls
    return wrapper


def get_task_config_cls(name: str) -> type:
    if name not in TASK_CONFIG_REGISTRY:
        raise KeyError(f"unknown task {name!r}; available: {sorted(TASK_CONFIG_REGISTRY)}")
    return TASK_CONFIG_REGISTRY[name]


@register_task_config("translation")
class TranslationTaskConfig(TaskConfig):
    source_lang: Optional[str] = argument(aliases=["s"], help="source language")
    target_lang: Optional[str] = argument(aliases=["t"], help="target language")
    source_langs: Optional[list[str]] = argument(
        nargs="+", help="source languages covered by the model (cartesian product with "
                        "target_langs gives the language pairs)")
    target_langs: Optional[list[str]] = argument(
        nargs="+", help="target languages covered by the model")
    lang_pairs: Optional[list[str]] = argument(
        aliases=["l"], nargs="+",
        help="explicit language pairs (overrides source_langs x target_langs)")
    allow_monolingual: bool = argument(
        False, help="allow same-language pairs (fr-fr), skipped by default")
    valid_source_langs: Optional[list[str]] = argument(
        nargs="+", help="source languages for validation corpora (training only)")
    valid_target_langs: Optional[list[str]] = argument(
        nargs="+", help="target languages for validation corpora (training only)")
    valid_lang_pairs: Optional[list[str]] = argument(
        nargs="+", help="language pairs for validation corpora (training only)")
    max_source_len: Optional[int] = argument(
        help="max source tokens (longer lines truncated at eval, skipped at training); "
             "default encoder_max_len")
    max_target_len: Optional[int] = argument(
        help="max target tokens; default decoder_max_len")
    min_len_ratio: Optional[float] = argument(
        help="skip pairs with src/tgt length ratio below this")
    max_len_ratio: Optional[float] = argument(
        help="skip pairs with src/tgt length ratio above this")
    escape_emojis: bool = argument(
        False, help="replace source emojis with placeholders and restore them in output")
    copy_placeholder: bool = argument(
        True, help="replace OOVs appearing on both sides by a copy token instead of <unk>")
    source_tags: Optional[list[str]] = argument(
        help="special tokens prepended to every source sentence")
    target_tags: Optional[list[str]] = argument(
        help="special tokens prepended to every target sentence")
    source_lang_code: bool = argument(
        False, help="prefix source lines with '<lang:SRC>'")
    target_lang_code: bool = argument(
        False, help="prepend '<lang:TGT>' to targets (forced as first decoder token)")
    lang_code: bool = argument(
        False, help="prefix source lines with the TARGET language code")
    domain_tag: bool = argument(
        False, help="prefix source lines with '<domain:D>'")
    target_dict: Optional[str] = argument(
        help="target dictionary path (default: same as --dict)")
    target_tokenizer: Optional[str] = argument(
        help="target-side tokenizer implementation (default: same as --tokenizer)")
    target_tokenizer_path: Optional[str] = argument(
        help="target-side tokenizer model path")
    target_spell_out: float = argument(0.0, help="target-side spell-out probability")
    target_bpe_dropout: float = argument(0.0, help="target-side BPE dropout")
    old_source_dict: Optional[str] = argument(
        help="old source dictionary for embedding re-mapping (vocab filtering)")
    old_target_dict: Optional[str] = argument(
        help="old target dictionary for embedding re-mapping")
    default_embed: Optional[str] = argument(
        "<unk>", help="embedding used to initialize unknown words when re-mapping")
    freeze_source_embed_regex: Optional[str] = argument(
        help="freeze source embeddings whose token matches this regex")

    @classmethod
    def format_path(cls, path: str, source_lang: str, target_lang: str) -> str:
        return (path.replace("{src}", source_lang)
                    .replace("{tgt}", target_lang)
                    .replace("{pair}", f"{source_lang}-{target_lang}"))

    def replace_placeholders(self, path: str) -> str:
        if self.lang_pairs:
            source_lang, target_lang = self.lang_pairs[0].split("-")
        else:
            source_lang = self.source_lang or "src"
            target_lang = self.target_lang or "tgt"
        return self.format_path(path, source_lang, target_lang)

    def finalize(self):
        super().finalize()
        if self.source_lang:
            if not self.source_langs:
                self.source_langs = [self.source_lang]
            elif self.source_lang not in self.source_langs:
                self.source_langs.append(self.source_lang)
        elif self.source_langs and len(self.source_langs) == 1:
            self.source_lang = self.source_langs[0]
        if self.target_lang:
            if not self.target_langs:
                self.target_langs = [self.target_lang]
            elif self.target_lang not in self.target_langs:
                self.target_langs.append(self.target_lang)
        elif self.target_langs and len(self.target_langs) == 1:
            self.target_lang = self.target_langs[0]
        for opt in ("target_tokenizer_path", "target_dict"):
            value = getattr(self, opt, None)
            if value:
                setattr(self, opt, self.replace_placeholders(value))

    def set_max_length(self, model_cfg) -> int:
        if self.max_target_len:
            assert self.max_target_len <= model_cfg.decoder_max_len
        else:
            self.max_target_len = model_cfg.decoder_max_len
        if model_cfg.model_type == "decoder":
            if self.max_source_len:
                assert self.max_source_len < self.max_target_len
            else:
                self.max_source_len = self.max_target_len // 2
            max_len = self.max_target_len
        else:
            if self.max_source_len:
                assert self.max_source_len <= model_cfg.encoder_max_len
            else:
                self.max_source_len = model_cfg.encoder_max_len
            max_len = max(self.max_source_len, self.max_target_len)
        assert self.batch_size >= max_len, \
            "batch size should be at least the maximum sequence length"
        return max_len


@register_task_config("speech_translation")
class SpeechTranslationTaskConfig(TranslationTaskConfig):
    pass


@register_task_config("doc_level_translation")
class DocumentLevelTranslationTaskConfig(TranslationTaskConfig):
    max_doc_size: int = argument(
        1, help="merge up to this many consecutive sentences of ordered corpora into "
                "documents (size sampled uniformly in [1, max])")
    sent_merge_prob: float = argument(
        0.0, help="probability of merging a sentence pair with the previous one")
    sent_sep: Optional[str] = argument(
        "<sep>", help="separator token between sentences of a document")


@register_task_config("language_modeling")
class LanguageModelingTaskConfig(TaskConfig):
    langs: Optional[list[str]] = argument(
        aliases=["l", "t", "target_langs"], nargs="+",
        help="languages of the training and validation corpora")
    valid_langs: Optional[list[str]] = argument(
        aliases=["valid_target_langs"], nargs="+",
        help="languages of the validation corpora")
    max_len: Optional[int] = argument(
        help="max tokens per line (default decoder_max_len)")
    tags: Optional[list[str]] = argument(help="tokens prepended to every sentence")
    lang_code: bool = argument(False, help="prefix sentences with '<lang:L>'")
    domain_tag: bool = argument(False, help="prefix sentences with '<domain:D>'")

    @classmethod
    def format_path(cls, path: str, lang: str) -> str:
        return path.replace("{lang}", lang)

    def replace_placeholders(self, path: str) -> str:
        lang = self.langs[0] if self.langs else "tgt"
        return self.format_path(path, lang)

    def set_max_length(self, model_cfg) -> int:
        if self.max_len:
            assert self.max_len <= model_cfg.decoder_max_len
        else:
            self.max_len = model_cfg.decoder_max_len
        assert self.batch_size >= self.max_len, \
            "batch size should be at least the maximum sequence length"
        return self.max_len


@register_task_config("dialogue")
class DialogueTaskConfig(LanguageModelingTaskConfig):
    chat_template: Optional[str] = argument(help="chat template name (e.g. 'zephyr')")
    system_prompt: Optional[str] = argument(help="system prompt, if the template has one")
    retriever_config: Optional[dict] = argument(
        help="retriever configuration for the playground (url, collection, templates)")


@register_task_config("nllb_translation")
class NLLBTranslationTaskConfig(TranslationTaskConfig):
    expert_ckpt: Optional[list[str]] = argument(help="paths to expert checkpoints")
    expert_json: Optional[str] = argument(
        help="JSON file mapping language pairs to expert checkpoint lists")
    expert_dir: Optional[str] = argument(
        help="directory containing the expert checkpoints")
