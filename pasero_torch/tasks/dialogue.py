# Copy of pasero_tpu/tasks/dialogue.py, verbatim.
"""Dialogue / chat task (pasero/tasks/dialogue.py).

Conversations (`User:`/`Assistant:` text or message lists) are rendered with a
registered chat template; the per-turn prompt mask is computed by diffing the
tokenization of incrementally-templated prefixes (dialogue.py:200-277), so the
loss only applies to assistant turns (with --prompt-loss 0).
"""

from __future__ import annotations

import logging
from typing import Union

import numpy as np
import regex

from ..config import register_chat_template, register_task
from ..config.registry import CHAT_TEMPLATE_REGISTRY
from ..config.tasks import DialogueTaskConfig
from ..tokenizers import bos, eos
from .language_modeling import LanguageModelingTask

logger = logging.getLogger("task")


@register_task("dialogue")
class DialogueTask(LanguageModelingTask):
    cfg: DialogueTaskConfig

    def __init__(self, data_dir: str, cfg: DialogueTaskConfig):
        cfg.keep_whitespaces = True
        template_name = cfg.chat_template or "chatml"
        assert template_name in CHAT_TEMPLATE_REGISTRY, \
            f"unknown chat template {template_name!r}"
        self.chat_template_fn = CHAT_TEMPLATE_REGISTRY[template_name]
        if template_name == "chatml" and "<|im_end|>" not in cfg.stop_sequences:
            cfg.stop_sequences.append("<|im_end|>")
        self.system_prompt = cfg.system_prompt
        self.prompt = (f"{self.system_prompt}\nUser: " if self.system_prompt
                       else "User: ")
        super().__init__(data_dir, cfg)

    @property
    def task_info(self) -> dict:
        return {**super().task_info, "prompt": self.prompt,
                "retriever_config": self.cfg.retriever_config}

    @property
    def inference_options(self) -> dict:
        options = {**super().inference_options, "task": "dialogue"}
        for name in ("chat_template", "system_prompt"):
            if getattr(self.cfg, name):
                options[name] = getattr(self.cfg, name)
        return options

    def input_to_sample(self, input: Union[str, list], meta: dict = {}) -> dict:
        """Parse 'User:'/'Assistant:' text or message lists into role dicts
        (dialogue.py:56-105)."""
        if isinstance(input, list):
            if all(isinstance(c, str) for c in input):
                conversation = [
                    {"role": "user" if i % 2 == 0 else "assistant",
                     "content": c} for i, c in enumerate(input)]
            else:
                assert all(isinstance(c, dict) for c in input)
                conversation = input
            return {"target": conversation, "meta": meta}

        pattern = r"(\nUser:|\nAssistant:)"
        if not regex.search(pattern, "\n" + input):
            input = f"User: {input}"
        parts = regex.split(pattern, "\n" + input)
        role = "system"
        conversation = []
        for content in parts:
            if content == "\nUser:":
                role = "user"
            elif content == "\nAssistant:":
                role = "assistant"
            else:
                content = content.strip()
                if content or role != "system":
                    conversation.append({"role": role, "content": content})
        if (self.system_prompt and conversation
                and conversation[0]["role"] != "system"):
            conversation.insert(0, {"role": "system",
                                    "content": self.system_prompt})
        return {"target": conversation, "meta": meta}

    def get_reference(self, sample: dict):
        last = sample["target"][-1]
        return last["content"] if last["role"] == "assistant" else None

    def preprocess(self, sample: dict, truncate: bool = False,
                   tokenize: bool = True, append_eos: bool = False) -> dict:
        assert tokenize, "dialogue requires tokenize=True (template diffing)"
        conversation = list(sample["target"])
        add_generation_prompt = False
        if not append_eos:  # inference-side conversation surgery
            if not conversation or (len(conversation) == 1
                                    and conversation[0]["role"] == "system"):
                conversation.append({"role": "user", "content": ""})
                add_generation_prompt = True
            elif (conversation[-1]["role"] == "assistant"
                  and not conversation[-1]["content"]):
                conversation = conversation[:-1]
                add_generation_prompt = True
            elif conversation[-1]["role"] == "user":
                add_generation_prompt = True

        formatted = self.chat_template_fn(
            conversation, add_generation_prompt=add_generation_prompt)
        last = conversation[-1]
        if not append_eos and last["role"] == "assistant" and last["content"]:
            # continue a partial assistant answer: strip the turn-end tokens
            start = formatted.rfind(last["content"])
            formatted = formatted[:start] + last["content"]

        all_tokens = self.preprocessor.tokenize(formatted)
        use_eos = append_eos and eos not in all_tokens
        decoder_input = self.preprocessor.binarize(all_tokens,
                                                   append_eos=use_eos)
        prompt_mask = np.ones_like(decoder_input, dtype=bool)

        # per-turn mask by incremental-prefix diffing (dialogue.py:200-277)
        for i, message in enumerate(conversation):
            if message["role"] != "assistant":
                continue
            prev = self.chat_template_fn(conversation[:i],
                                         add_generation_prompt=True)
            current = self.chat_template_fn(conversation[:i + 1],
                                            add_generation_prompt=False)
            assert current.startswith(prev)
            prev_tokens = self.preprocessor.tokenize(prev)
            current_tokens = self.preprocessor.tokenize(current)
            assert all_tokens[:len(prev_tokens)] == prev_tokens, \
                "this preprocessor is not compatible with this chat template"
            prev_len, current_len = len(prev_tokens), len(current_tokens)
            if i == len(conversation) - 1 and use_eos:
                current_len += 1  # the final EOS belongs to the answer
            prompt_mask[prev_len:current_len] = False

        if truncate and self.max_len:
            decoder_input = decoder_input[:self.max_len]
            prompt_mask = prompt_mask[:self.max_len]
        if self.max_len and len(decoder_input) > self.max_len:
            return {}
        return {"decoder_input": decoder_input, "prompt_mask": prompt_mask,
                "emojis": [], "meta": sample.get("meta", {})}


# -- chat templates (dialogue.py:277-360) -------------------------------------

@(lambda f: (register_chat_template("chatml", f), f)[1])
def apply_chatml_template(conversation, add_generation_prompt=True) -> str:
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
           for m in conversation]
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


@(lambda f: (register_chat_template("llama-2", f), f)[1])
def apply_llama2_template(conversation, add_generation_prompt=True) -> str:
    out = []
    system = ""
    if conversation and conversation[0]["role"] == "system":
        system = f"<<SYS>>\n{conversation[0]['content']}\n<</SYS>>\n\n"
        conversation = conversation[1:]
    for m in conversation:
        if m["role"] == "user":
            out.append(f"{bos}[INST] {system}{m['content'].strip()} [/INST] ")
            system = ""
        elif m["role"] == "assistant":
            out.append(f" {m['content'].strip()} {eos}")
        else:
            raise ValueError(m["role"])
    return "".join(out)


@(lambda f: (register_chat_template("mistral", f), f)[1])
def apply_mistral_template(conversation, add_generation_prompt=True) -> str:
    out = []
    if conversation and conversation[0]["role"] == "system":
        if conversation[0]["content"]:
            logger.warning("the mistral template has no system prompt; ignored")
        conversation = conversation[1:]
    for i, m in enumerate(conversation):
        prefix = bos if i == 0 else ""
        if m["role"] == "user":
            out.append(f"{prefix}[INST] {m['content']} [/INST]")
        elif m["role"] == "assistant":
            out.append(f" {m['content']}{eos}")
        else:
            raise ValueError(m["role"])
    return "".join(out)


@(lambda f: (register_chat_template("zephyr", f), f)[1])
def apply_zephyr_template(conversation, add_generation_prompt=True) -> str:
    out = [f"<|{m['role']}|>\n{m['content']}{eos}\n" for m in conversation]
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


@(lambda f: (register_chat_template("solar", f), f)[1])
def apply_solar_template(conversation, add_generation_prompt=True) -> str:
    role_names = {"system": "System", "user": "User", "assistant": "Assistant"}
    out = [f"### {role_names[m['role']]}:\n{m['content']}\n\n"
           for m in conversation]
    if add_generation_prompt:
        out.append("### Assistant:\n")
    return "".join(out)
