"""VQA metrics (medplib_tpu/eval/vqa_metrics.py): exact match, token
F1 / precision / recall, BLEU-1/2/3, closed accuracy, candidate-set open
accuracy.

The word normalization follows the standard VQAv2 evaluation recipe:
strip punctuation (context-sensitive), drop articles, expand
contractions, map number words to digits. BLEU is nltk's sentence_bleu
with its default (no) smoothing, computed here in pure Python, so the
metrics need no package beyond the standard library.
"""

from __future__ import annotations

import collections
import math
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
ARTICLES = {"a", "an", "the"}
CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve":
    "could've", "couldnt": "couldn't", "didnt": "didn't", "doesnt":
    "doesn't", "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hes": "he's", "howd": "how'd",
    "howll": "how'll", "hows": "how's", "isnt": "isn't", "itd": "it'd",
    "itll": "it'll", "lets": "let's", "mightve": "might've", "mustve":
    "must've", "shant": "shan't", "shed": "she'd", "shes": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "thats": "that's",
    "theres": "there's", "theyd": "they'd", "theyll": "they'll", "theyre":
    "they're", "theyve": "they've", "wasnt": "wasn't", "werent": "weren't",
    "whatll": "what'll", "whats": "what's", "whered": "where'd", "wheres":
    "where's", "whod": "who'd", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "wont": "won't", "wouldve": "would've", "wouldnt":
    "wouldn't", "yall": "y'all", "youd": "you'd", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
         "-", ">", "<", "@", "`", ",", "?", "!"]
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")


def normalize_word(token: str) -> str:
    out = token
    for p in PUNCT:
        if (p + " " in token or " " + p in token) or \
                _COMMA_STRIP.search(token) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out)
    words = []
    for w in out.lower().split():
        w = MANUAL_MAP.get(w, w)
        if w not in ARTICLES:
            words.append(w)
    words = [CONTRACTIONS.get(w, w) for w in words]
    return " ".join(words).replace(",", "")


def split_sentence(sentence: str, n: int) -> Dict[str, int]:
    words: Dict[str, int] = collections.defaultdict(int)
    toks = sentence.lower().strip().split()
    for i in range(len(toks) - n + 1):
        gram = " ".join(toks[i:i + n])
        if gram:
            words[gram] += 1
    return words


def calculate_exactmatch(candidate: str, reference: str) -> float:
    cw = split_sentence(normalize_word(candidate), 1)
    rw = split_sentence(normalize_word(reference), 1)
    count = sum(1 for w in rw if w in cw)
    total = sum(cw.values())
    return count / total if total else 0.0


def calculate_f1score(candidate: str, reference: str) -> Tuple[float, float, float]:
    cw = split_sentence(normalize_word(candidate), 1)
    rw = split_sentence(normalize_word(reference), 1)
    if not cw or not rw:
        return 0.0, 0.0, 0.0
    tp = fp = fn = 0
    for w in set(cw) | set(rw):
        if w in cw and w in rw:
            tp += cw[w]
        elif w in cw:
            fp += cw[w]
        else:
            fn += rw[w]
    if tp == 0:
        return 0.0, 0.0, 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall), precision, recall


def calculate_appearance_with_normalization(
        prediction: str, reference: str,
        candidate_set: Iterable[str]) -> float:
    pred = normalize_word(prediction)
    ref = normalize_word(reference)
    pw = split_sentence(pred, 1)
    best, best_sim = None, -1.0
    for cand in candidate_set:
        cn = normalize_word(str(cand))
        cw = split_sentence(cn, 1)
        if not cw:
            sim = 0.0
        else:
            sim = sum(1 for w in pw if w in cw) / len(cw)
        if sim > best_sim:
            best, best_sim = cn, sim
    return 1.0 if (best == ref or pred == ref) else 0.0


def _ngrams(tokens: List[str], n: int) -> Dict[Tuple[str, ...], int]:
    out: Dict[Tuple[str, ...], int] = collections.defaultdict(int)
    for i in range(len(tokens) - n + 1):
        out[tuple(tokens[i:i + n])] += 1
    return out


def sentence_bleu(reference: List[str], hypothesis: List[str],
                  weights=(0.25, 0.25, 0.25, 0.25)):
    """nltk.translate.bleu_score.sentence_bleu([reference], hypothesis,
    weights) with no smoothing: clipped n-gram precisions up to order 4,
    a zero precision counted as sys.float_info.min, the brevity penalty
    against the one reference; 0 (an int) when no unigram matches."""
    nums, dens = [], []
    for n in range(1, len(weights) + 1):
        hyp = _ngrams(hypothesis, n) if len(hypothesis) >= n else {}
        ref = _ngrams(reference, n) if len(reference) >= n else {}
        nums.append(sum(min(c, ref.get(g, 0)) for g, c in hyp.items()))
        dens.append(max(1, sum(hyp.values())))
    if nums[0] == 0:
        return 0
    hyp_len, ref_len = len(hypothesis), len(reference)
    if hyp_len > ref_len:
        bp = 1
    else:
        bp = math.exp(1 - ref_len / hyp_len)
    p_n = [num / den if num else sys.float_info.min
           for num, den in zip(nums, dens)]
    return bp * math.exp(math.fsum(w * math.log(p)
                                   for w, p in zip(weights, p_n)))


def bleu_scores(candidate: str, reference: str):
    """BLEU-4/1/2/3 as nltk's sentence_bleu gives them."""
    ref = str(reference).lower().split()
    hyp = str(candidate).lower().split()
    return {
        "bleu_score": sentence_bleu(ref, hyp),
        "bleu_score_1": sentence_bleu(ref, hyp, weights=(1, 0, 0, 0)),
        "bleu_score_2": sentence_bleu(ref, hyp, weights=(0, 1, 0, 0)),
        "bleu_score_3": sentence_bleu(ref, hyp, weights=(0, 0, 1, 0)),
    }


def evaluate_vqa(records: Sequence[dict],
                 candidate_set: Optional[Iterable[str]] = None,
                 by_modality_key: Optional[str] = None) -> Dict[str, float]:
    """records: dicts with 'text' (prediction), 'gt', 'answer_type'
    (open/other/number vs yes/no/closed). Returns the score table as a
    dict (values in %). With `by_modality_key`, also returns per-modality
    sub-tables."""
    open_scores = collections.defaultdict(list)
    closed_hits: List[int] = []
    by_mod: Dict[str, list] = collections.defaultdict(list)

    for item in records:
        gt = normalize_word(str(item["gt"]).lower())
        pred = normalize_word(str(item["text"]).lower())
        at = str(item.get("answer_type", "open")).lower()
        if by_modality_key:
            by_mod[str(item.get(by_modality_key, "unknown"))].append(item)
        if at in ("open", "other", "number"):
            open_scores["exact"].append(calculate_exactmatch(pred, gt))
            f1, p, r = calculate_f1score(pred, gt)
            open_scores["f1"].append(f1)
            open_scores["precision"].append(p)
            open_scores["recall"].append(r)
            for k, v in bleu_scores(pred, gt).items():
                open_scores[k].append(v)
            if candidate_set is not None:
                open_scores["open_hit"].append(
                    calculate_appearance_with_normalization(
                        pred, gt, candidate_set))
        elif at in ("yes/no", "closed"):
            closed_hits.append(1 if gt == pred else 0)

    def avg(xs):
        return 100.0 * sum(xs) / len(xs) if xs else 0.0

    out = {
        "exact_match_acc": avg(open_scores["exact"]),
        "f1": avg(open_scores["f1"]),
        "precision": avg(open_scores["precision"]),
        "recall": avg(open_scores["recall"]),
        "bleu": avg(open_scores["bleu_score"]),
        "bleu_1": avg(open_scores["bleu_score_1"]),
        "bleu_2": avg(open_scores["bleu_score_2"]),
        "bleu_3": avg(open_scores["bleu_score_3"]),
        "open_accuracy": avg(open_scores.get("open_hit", [])),
        "closed_accuracy": avg(closed_hits),
        "num_open": float(len(open_scores["exact"])),
        "num_closed": float(len(closed_hits)),
    }
    if by_modality_key:
        out["per_modality"] = {
            m: evaluate_vqa(items, candidate_set)
            for m, items in by_mod.items()}
    return out
