"""Conversation prompt templates (medplib_tpu/data/conversation.py):
`SeparatorStyle`, `Conversation` and every template of `conv_templates`,
with the same prompts. `llava_v1` is the training template, `v1` the
serving and eval template.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        # Image-attachment form: the first message may be a tuple
        # (text, image, process_mode) as sent by the web UI. mmtag versions
        # announce the image as its own <Image>..</Image> round; others
        # prepend "<image>\n" (reference conversation.py:31-43).
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in messages]
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, init_msg]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, "<image>\n" + init_msg]
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):  # conversation.py:67
                        message = message[0]
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):  # conversation.py:82
                        message = message[0]
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):  # conversation.py:99
                        message = message[0]
                    ret += message + seps[i % 2]
            return ret
        raise ValueError(f"invalid separator style {self.sep_style}")

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages], offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            version=self.version)


_V0_SEED = [
    ["Human",
     "What are the key differences between renewable and non-renewable "
     "energy sources?"],
    ["Assistant",
     "Renewable energy sources are those that can be replenished naturally "
     "in a relatively short amount of time, such as solar, wind, hydro, "
     "geothermal, and biomass. Non-renewable energy sources, on the other "
     "hand, are finite and will eventually be depleted, such as coal, oil, "
     "and natural gas. Here are some key differences between renewable and "
     "non-renewable energy sources:\n"
     "1. Availability: Renewable energy sources are virtually inexhaustible, "
     "while non-renewable energy sources are finite and will eventually run "
     "out.\n"
     "2. Environmental impact: Renewable energy sources have a much lower "
     "environmental impact than non-renewable sources, which can lead to "
     "air and water pollution, greenhouse gas emissions, and other negative "
     "effects.\n"
     "3. Cost: Renewable energy sources can be more expensive to initially "
     "set up, but they typically have lower operational costs than "
     "non-renewable sources.\n"
     "4. Reliability: Renewable energy sources are often more reliable and "
     "can be used in more remote locations than non-renewable sources.\n"
     "5. Flexibility: Renewable energy sources are often more flexible and "
     "can be adapted to different situations and needs, while non-renewable "
     "sources are more rigid and inflexible.\n"
     "6. Sustainability: Renewable energy sources are more sustainable over "
     "the long term, while non-renewable sources are not, and their "
     "depletion can lead to economic and social instability.\n"],
]

conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the human's questions.",
    roles=("Human", "Assistant"), messages=[list(m) for m in _V0_SEED],
    offset=2, sep_style=SeparatorStyle.SINGLE, sep="###", version="v0")

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the user's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"), version="llama_v2", messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), version="llama_v2", messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_llava_plain = Conversation(
    system="", roles=("", ""), messages=[], offset=0,
    sep_style=SeparatorStyle.PLAIN, sep="\n")

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the human's questions.",
    roles=("Human", "Assistant"),
    messages=[["Human", "Hi!"],
              ["Assistant", "Hi there! How can I help you today?"]],
    offset=2, sep_style=SeparatorStyle.SINGLE, sep="###")

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the human's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

# mmtag variants: identical separator schemes but the image arrives as its
# own <Image>visual content</Image> round (reference conversation.py:343-378)
_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user "
    "provides, and assist the user with a variety of tasks using natural "
    "language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.")

conv_llava_v0_mmtag = Conversation(
    system=_MMTAG_SYSTEM, roles=("Human", "Assistant"), messages=[],
    offset=0, sep_style=SeparatorStyle.SINGLE, sep="###", version="v0_mmtag")

conv_llava_v1_mmtag = Conversation(
    system=_MMTAG_SYSTEM, roles=("USER", "ASSISTANT"), messages=[],
    offset=0, sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
    version="v1_mmtag")

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an LLM-based "
    "AI assistant. The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[],
    offset=0, sep_style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")

default_conversation = conv_vicuna_v1
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
