"""Tokenization (medplib_tpu/data/tokenize.py): vocabulary surgery,
`<image>` / region sentinels, `<image>` placement and vicuna-v1 round
masking.

- add_special_tokens: the extra tokens of config.EXTRA_TOKENS
- tokenizer_image_token: <image> -> IMAGE_TOKEN_INDEX sentinel,
  REGION_TOKEN_INDEX inserted between the ids of <region> and </region>
- preprocess_multimodal: move a turn's single <image> to its front
- preprocess_v1: vicuna-v1 round-based target masking with IGNORE_INDEX
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from medplib_tpu_torch.config import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                                DEFAULT_IMAGE_TOKEN, EXTRA_TOKENS,
                                IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                REGION_TOKEN_INDEX)
from medplib_tpu_torch.data.conversation import Conversation, SeparatorStyle


def add_special_tokens(tokenizer) -> Dict[str, int]:
    """Vocabulary surgery (train_ds_medplib.py:207-216). Returns name->id for
    the added tokens; `<SEG>`'s id is config.seg_token_idx."""
    tokenizer.add_tokens(list(EXTRA_TOKENS))
    tokenizer.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                         special_tokens=True)
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.unk_token
    return {t: tokenizer.convert_tokens_to_ids(t) for t in EXTRA_TOKENS}


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Tokenize with <image> sentinels; REGION sentinel goes between
    <region> and </region> token ids."""
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        input_ids.extend(x[offset:])

    r_open = tokenizer("<region>", add_special_tokens=False).input_ids[0]
    r_close = tokenizer("</region>", add_special_tokens=False).input_ids[0]
    i = 0
    while i < len(input_ids) - 1:
        if input_ids[i] == r_open and input_ids[i + 1] == r_close:
            input_ids.insert(i + 1, REGION_TOKEN_INDEX)
            i += 1
        i += 1
    return input_ids


def preprocess_multimodal(sources: Sequence[List[dict]],
                          use_im_start_end: bool = False):
    """Move <image> to the front of any single-image turn.

    Deviation from the reference (LazySupervisedDataset.py:108-113): the
    reference's replace-all-then-prepend-one collapses MULTI-image turns to a
    single <image>, which would break ICL prompts (2n+1 sentinels expected,
    ICLLazySupervisedDataset.py:139-142); turns with >1 <image> are left
    in place here.
    """
    for source in sources:
        for sentence in source:
            value = str(sentence["value"])
            if value.count(DEFAULT_IMAGE_TOKEN) == 1:
                value = value.replace(DEFAULT_IMAGE_TOKEN, "").strip()
                value = (DEFAULT_IMAGE_TOKEN + "\n" + value).strip()
            if DEFAULT_IMAGE_TOKEN in value and use_im_start_end:
                value = value.replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN +
                    DEFAULT_IM_END_TOKEN)
            sentence["value"] = value
    return sources


def preprocess_v1(sources: Sequence[List[dict]], tokenizer,
                  conv_template: Conversation,
                  has_image: bool = False) -> Dict:
    """Apply the vicuna-v1 template and build IGNORE_INDEX-masked labels.

    Returns dict(input_ids [N, T] np.int64, labels [N, T], conversations,
    question, gt) — ragged rows are NOT padded here (collator's job).
    """
    conv = conv_template.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations, question, gt = [], [], []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            value = str(sentence["value"])
            if sentence["from"] == "human":
                question.append(value.replace("<im_start><image><im_end>\n", ""))
            else:
                gt.append(value)
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, value)
        conversations.append(conv.get_prompt())

    def tok(text):
        if has_image:
            return tokenizer_image_token(text, tokenizer)
        return tokenizer(text).input_ids

    input_ids = [np.asarray(tok(c), np.int64) for c in conversations]
    targets = [ids.copy() for ids in input_ids]

    assert conv.sep_style == SeparatorStyle.TWO
    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != tokenizer.pad_token_id))
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if has_image:
                round_len = len(tokenizer_image_token(rou, tokenizer))
                instruction_len = len(
                    tokenizer_image_token(parts[0], tokenizer)) - 2
            else:
                round_len = len(tokenizer(rou).input_ids)
                instruction_len = len(tokenizer(parts[0]).input_ids) - 2
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX  # tokenization mismatch -> drop sample

    return dict(input_ids=input_ids, labels=targets,
                conversations=conversations, question=question, gt=gt)
