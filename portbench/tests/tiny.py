"""A tiny copy of a cell (its configuration cut to test size, served in
float32, and a small batch) written into a directory, for CPU tests of the
harness, the reference and the comparison."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CELL = "moe-ground-b16"
TRAIN_CELL = "qlora-long-b8"


def tiny_model(config: str = "medplib2e-dsllm7b-int4h") -> dict:
    with open(HERE / "configs" / f"{config}.json") as f:
        m = json.load(f)
    m.update(hidden_size=128, intermediate_size=256, num_attention_heads=4,
             num_key_value_heads=4, head_dim=32, num_hidden_layers=2,
             vocab_size=500, bos_token_id=498, eos_token_id=499)
    med = m["medplib"]
    med.update(seg_token_idx=500, vocab_size_padded=768)
    med["vision"].update(image_size=56, patch_size=14, hidden_size=64,
                         intermediate_size=128, num_layers=3, num_heads=4)
    med["projector"].update(mm_hidden_size=64)
    med["sam"].update(image_size=64, patch_size=16, encoder_embed_dim=64,
                      encoder_depth=2, encoder_num_heads=2,
                      encoder_global_attn_indexes=[1], window_size=2,
                      prompt_embed_dim=32, mask_in_chans=4,
                      decoder_mlp_dim=64, decoder_num_heads=2,
                      iou_head_hidden_dim=32)
    med["seg"].update(out_dim=32)
    return m


def write(root: Path, dtype: str = "float32") -> Path:
    """The tiny cell under `root`; -> its BENCHMARK.json."""
    root = Path(root)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "mixes").mkdir(exist_ok=True)
    model = tiny_model()
    model["serving"]["dtype"] = dtype
    (root / "tiny.json").write_text(json.dumps(model))
    with open(HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [dict(c, file="tiny.json") for c in bench["configs"]
                        if c["name"] == "medplib2e-dsllm7b-int4h"]
    bench["workloads"] = [dict(w, traffic="tiny") for w in bench["workloads"]
                          if w["name"] == CELL]
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


def write_train(root: Path, dtype: str = "float32") -> Path:
    """A tiny stage-3 training cell under `root` (the training driver and
    reference, which no cell of BENCHMARK.json runs yet); -> its
    BENCHMARK.json."""
    root = Path(root)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "mixes").mkdir(exist_ok=True)
    model = tiny_model("lisa-dsllm7b-qlora")
    model["training"]["dtype"] = dtype
    (root / "tiny_train.json").write_text(json.dumps(model))
    bench = {
        "configs": [{"name": model["name"], "source": model["source"],
                     "file": "tiny_train.json", "reduced": [], "why": "-"}],
        "workloads": [{"name": TRAIN_CELL, "config": model["name"],
                       "traffic": "tiny_sft", "chips": 1, "why": "-"}],
        "end_to_end": [
            {"name": "train_tokens_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.05, "source": "host_clock",
             "workloads": [TRAIN_CELL]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": n, "unit": "%", "better": b, "source": s,
             "layer": "-", "moves": "train_tokens_per_s",
             "workloads": [TRAIN_CELL]}
            for n, b, s in (("flash_roofline.train", "higher",
                             "device_trace"),
                            ("mfu.train", "higher", "host_clock"),
                            ("idle_share.train", "lower", "device_trace"))]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "mixes" / "tiny_sft.json").write_text(json.dumps({
        "kind": "seg_sft", "batch": 3, "images_per_row": 1,
        "text_len_min": 12, "text_len_max": 20, "lengths": "spread",
        "image_at": 2, "seg_from_end": 3, "label_mask_share": 0.5}))
    (root / "workloads" / f"{TRAIN_CELL}.json").write_text(json.dumps({
        "driver": "train_step", "profile_calls": 2, "check_steps": 3,
        "limits": {"grad_norm_gap_median": 0.02, "embed_rows_gap": 0.05,
                   "change_norm_gap": 0.35}}))
    return root / "BENCHMARK.json"
