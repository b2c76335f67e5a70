"""The traffic generator: the same seed gives the same inputs, other seeds
other inputs with the same work, and the batches hold what the mix says."""

import json
from pathlib import Path

import numpy as np
import torch

from portbench import traffic

PB = Path(__file__).resolve().parents[1]


def _model():
    with open(PB / "configs" / "medplib2e-dsllm7b-int4h.json") as f:
        return json.load(f)


def _mix():
    return traffic.load_mix("ground-b16")


def test_same_seed_same_batch():
    m, mix = _model(), _mix()
    a = traffic.make(mix, m, 2 ** 31 + 77, 3, "cpu")
    b = traffic.make(mix, m, 2 ** 31 + 77, 3, "cpu")
    for k in ("ids", "mask", "clip", "sam"):
        assert torch.equal(a[k], b[k])
    assert np.array_equal(a["lens"], b["lens"])


def test_seeds_and_calls_differ_in_content_not_work():
    m, mix = _model(), _mix()
    a = traffic.make(mix, m, 11, 0, "cpu")
    b = traffic.make(mix, m, 12, 0, "cpu")
    c = traffic.make(mix, m, 11, 1, "cpu")
    assert not torch.equal(a["ids"], b["ids"])
    assert not torch.equal(a["clip"], c["clip"])
    for x in (a, b, c):
        assert sorted(x["lens"]) == sorted(a["lens"])
        assert x["ids"].shape == a["ids"].shape


def test_batch_layout():
    m, mix = _model(), _mix()
    b = traffic.make(mix, m, 5, 0, "cpu")
    lens = b["lens"]
    assert len(lens) == mix["batch"] == 16
    assert lens.min() == mix["text_len_min"] and \
        lens.max() == mix["text_len_max"]
    seg = m["medplib"]["seg_token_idx"]
    for r, n in enumerate(lens):
        row = b["ids"][r]
        assert int(row[0]) == m["bos_token_id"]
        assert int(row[mix["image_at"]]) == traffic.IMAGE_TOKEN_INDEX
        assert int(row[n - mix["seg_from_end"]]) == seg
        assert int(b["mask"][r].sum()) == n and not row[n:].any()
        text = row[:n]
        body = text[(text != seg) & (text != traffic.IMAGE_TOKEN_INDEX)]
        assert int(body[1:].min()) >= 3
        assert int(body[1:].max()) < m["bos_token_id"]
    assert b["clip"].shape == (16, 1, 336, 336, 3)
    assert b["sam"].shape == (16, 256, 256, 3)


def test_generator_reads_only_the_mix_the_model_and_the_seed():
    """Changing the program cannot change the inputs: the generator's
    module imports nothing of it."""
    src = Path(traffic.__file__).read_text()
    assert "medplib_tpu" not in src and "import portbench" not in src
