"""The DeepSeek-V2 cell cut to test size (tiny.py's CLIP and SAM sizes),
written into a directory, for CPU and card tests of its driver, reference
and comparison."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.tests.tiny import HERE, tiny_model

CELL = "dsv2lite-ground-b64"


def tiny_dsv2_model() -> dict:
    """medplib-dsv2lite-int4h cut to test size, with the published head
    sizes (q / k 128 + 64, v 128: K4 <192, 128> on the card), wide enough
    for K1's int4h route (hidden 256) and K2 (expert width 200, padded to
    256)."""
    m = tiny_model("medplib-dsv2lite-int4h")
    m.update(hidden_size=256, intermediate_size=384, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=64,
             n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
             moe_intermediate_size=200)
    m.pop("head_dim")
    m["rope_scaling"] = dict(m["rope_scaling"],
                             original_max_position_embeddings=64)
    return m


def write(root: Path, dtype: str = "bfloat16") -> Path:
    """The tiny DeepSeek-V2 cell under `root`; -> its BENCHMARK.json."""
    root = Path(root)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "mixes").mkdir(exist_ok=True)
    model = tiny_dsv2_model()
    model["serving"]["dtype"] = dtype
    (root / "tiny_dsv2.json").write_text(json.dumps(model))
    with open(HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [dict(c, file="tiny_dsv2.json")
                        for c in bench["configs"]
                        if c["name"] == "medplib-dsv2lite-int4h"]
    bench["workloads"] = [dict(w, traffic="tiny")
                          for w in bench["workloads"] if w["name"] == CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "mixes" / "tiny.json").write_text(json.dumps({
        "kind": "grounded_vqa", "batch": 4,
        "images_per_row": 1, "text_len_min": 12, "text_len_max": 20,
        "lengths": "spread", "image_at": 2, "seg_from_end": 3,
        "new_tokens": 3}))
    with open(HERE / "workloads" / f"{CELL}.json") as f:
        cell = json.load(f)
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    return root / "BENCHMARK.json"
