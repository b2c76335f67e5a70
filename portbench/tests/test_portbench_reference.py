"""The plain reference against the port at a tiny configuration: the
quantization copy against the port's quantizers, and one grounded
generate call, the port in float32, against the reference's logits and
mask."""

import torch

from portbench import harness
from portbench.reference import quant, serve
from portbench.tests import tiny


def test_int8_copy_equals_the_port():
    from medplib_tpu_torch.utils import quantize as qz
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 64, 48, generator=gen).to(torch.bfloat16)
    node = qz.quantize_tree({"o_proj": {"kernel": w.clone()}},
                            skip=())["o_proj"]
    port = node["kernel"].float() * node["scale"]
    assert torch.equal(quant.int8_channel(w, 1), port)
    t = qz.quantize_tree({"q_proj": {"kernel": w.clone()}},
                         skip=())["q_proj"]
    assert torch.equal(quant.int8_channel(w, 2),
                       t["kernel"].float() * t["scale"])


def test_int4h_expert_copy_equals_the_port():
    from medplib_tpu_torch.utils import quantize as qz
    gen = torch.Generator().manual_seed(1)
    e, h, m = 2, 256, 1000
    ex = {"gate_proj": {"kernel": torch.randn(e, h, m, generator=gen)
                        .to(torch.bfloat16)},
          "up_proj": {"kernel": torch.randn(e, h, m, generator=gen)
                      .to(torch.bfloat16)},
          "down_proj": {"kernel": torch.randn(e, m, h, generator=gen)
                        .to(torch.bfloat16)}}
    want = {n: quant.padded_experts(v["kernel"], 1 if n == "down_proj"
                                    else 2, 1024, 2)
            for n, v in ex.items()}
    q = qz.quantize_tree(qz.pad_moe_experts_for_gmm(ex), skip=(), bits=4,
                         int4_groups=2)
    for n, node in q.items():
        got = qz.dequant_int4h(node["kernel"], node["scale4h"],
                               torch.float32)
        m_axis = 1 if n == "down_proj" else 2
        assert torch.equal(got.narrow(m_axis, 0, m), want[n])


def test_one_generate_call_matches(tmp_path):
    bench = tiny.write(tmp_path)
    _, cell, model, mix = harness.cell_spec(tiny.CELL, bench, tmp_path)
    drv = harness._module(harness.HERE / "drivers" / "generate_batch.py")
    d = drv.Driver(model, mix, cell, 2 ** 31 + 5, "cpu")
    d.setup()
    out = d._call(0)
    d.release()
    want = serve.run(model, mix, 2 ** 31 + 5, [0], [out["ids"]], "cpu", 8)
    r = serve.readings(want, serve.program_masks([out["masks"]], "cpu"))
    assert r["logit_gap_max"] == 0.0 and r["tokens"] == 12
    assert r["mask_rel_max"] < 1e-4


def test_first_train_steps_match(tmp_path):
    """Three QLoRA steps of the port in float32 (dropout, adapters, the
    clip and AdamW) against the reference's."""
    from portbench.reference import train
    bench = tiny.write_train(tmp_path)
    _, cell, model, mix = harness.cell_spec(tiny.TRAIN_CELL, bench, tmp_path)
    drv = harness._module(harness.HERE / "drivers" / "train_step.py")
    d = drv.Driver(model, mix, cell, 2 ** 31 + 9, "cpu")
    d.setup()
    d.release()
    want = train.run(model, mix, 2 ** 31 + 9, cell["check_steps"], "cpu", 8)
    r = train.readings(d.program_readings(), want)
    assert r["leaves_missing"] == 0 and r["leaves_compared"] > 50
    assert r["loss_rel_max"] < 1e-5 and r["embed_rows_gap"] == 0.0
    assert r["grad_norm_gap"] < 1e-4 and r["change_norm_gap"] < 1e-4
