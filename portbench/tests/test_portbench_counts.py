"""The yardstick's counts against values worked by hand, and the kernel
name map."""

import json
import re
from pathlib import Path

import pytest

from portbench import counts

CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "medplib2e-dsllm7b-int4h.json"


def model():
    with open(CONFIG) as f:
        return json.load(f)


def test_bound():
    assert counts.bound(3.35e12, 0.0, counts.INT8_OPS) == (1.0, "bytes")
    assert counts.bound(0.0, 1979e12, counts.INT8_OPS) == (1.0,
                                                          "operations")


def test_llm_layer_by_hand():
    m = {"hidden_size": 8, "intermediate_size": 16, "head_dim": 4,
         "num_attention_heads": 2, "num_key_value_heads": 2,
         "medplib": {"moe": {"num_experts": 2, "top_k": 1}}}
    # q/k/v/o 2*3*8*32 = 1536; QK^T + PV 2*2*6*8 = 192; router 2*3*8*2 =
    # 96; one expert 2*3*3*8*16 = 2304
    assert counts.llm_layer_flops(m, 3, 6) == 1536 + 192 + 96 + 2304


def test_clip_by_hand():
    v = {"hidden_size": 8, "intermediate_size": 16, "patch_size": 14,
         "image_size": 28, "num_layers": 3, "select_layer": -2}
    # 4 patches + CLS = 5 tokens, 2 layers run; patch conv 2*4*14*14*3*8;
    # a layer: projections 2*5*4*64, scores + values 2*2*25*8, MLP
    # 2*2*5*8*16
    layer = 2560 + 800 + 2560
    assert counts.clip_flops(v) == 37632 + 2 * layer


def test_sam_encoder_by_hand():
    s = {"encoder_embed_dim": 8, "patch_size": 16, "image_size": 32,
         "window_size": 2, "prompt_embed_dim": 4, "mlp_ratio": 2.0,
         "adapter_ratio": 0.5, "encoder_depth": 2,
         "encoder_global_attn_indexes": [1]}
    # 2 x 2 grid: patch conv 2*4*16*16*3*8 = 49152; a block: attention
    # 2*2*4*4*8 + rel-pos 2*4*2*2*8 = 768, linears 2*4*8*24 + 2*4*8*8 +
    # 2*2*4*8*16 = 4096, adapter 2*8*4*2 + 2*9*64 + 2*16*64 = 3328;
    # neck 2*4*8*4 + 2*4*9*16 = 1408
    assert counts.sam_encoder_flops(s) == 49152 + 2 * (768 + 4096 + 3328) \
        + 1408


def test_decode_step_adds_one_layer_pass_per_layer():
    m = model()
    one = counts.serve_call_flops(m, [700], 1)
    none = counts.serve_call_flops(m, [700], 0)
    h, vp = m["hidden_size"], m["medplib"]["vocab_size_padded"]
    fcs = 2 * (h * h + h * m["medplib"]["seg"]["out_dim"])
    want = 30 * counts.llm_layer_flops(m, 1, 701) + 2 * h * vp + fcs
    assert one - none == pytest.approx(want, rel=1e-12)


def test_kernel_bounds_by_hand():
    m = model()
    # K1: 30 layers x (gate, up, down) at 2*9968*4096*11008 int8 operations
    k1 = 30 * 3 * 2 * 9968 * 4096 * 11008 / 1979e12
    assert counts.k1_bound_s(m, 9968) == pytest.approx(k1, rel=1e-12)
    # K2: both experts' int4 weights and f32 scales, 16 rows in and out
    w = 2 * (3 * 4096 * 11008 // 2 + 2 * (2 * 11008 + 4096) * 4)
    k2 = 30 * 10 * (w + 2 * 16 * 4096 * 2) / 3.35e12
    assert counts.k2_bound_s(m, 16, 10) == pytest.approx(k2, rel=1e-12)


@pytest.mark.parametrize("name,kid", [
    ("void s8mma::s8_mma_kernel<64, 128, 32, 4, (s8mma::Layout)2, "
     "(s8mma::Epilogue)2>(signed char const*, signed char const*)", "K1"),
    ("void s8mma::s8_mma_kernel<64, 128, 32, 4, (s8mma::Layout)1, "
     "(s8mma::Epilogue)1>(signed char const*)", "K3"),
    ("void s8mma::s8_mma_kernel<64, 128, 32, 4, s8mma::kKN, "
     "s8mma::kAsWs>(signed char const*)", "K8"),
    ("void int4h_mma_kernel<64, 128, 32, 6, false, 8, true>(...)", "K1"),
    ("void int4h_mma_kernel<64, 128, 32, 6, true, 8, false>(...)", "K9"),
    ("moe_down_kernel(void const*, float const*)", "K2"),
    ("moe_act_kernel", "K2"),
    ("void flash_fwd_mma_kernel(__nv_bfloat16 const*)", "K4"),
    ("void flash_dq_kernel<float>(float const*)", "K5"),
    ("void flash_dkv_mma_kernel(__nv_bfloat16 const*)", "K6"),
    ("void gmm_kernel<signed char, float, 64>(void const*)", "K3"),
    ("int8_matmul_kernel(float const*)", "K7"),
    ("int4h_matmul_f32_kernel(float const*)", "K9"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
    ("void at::native::elementwise_kernel<128, 2>(int, float)", None),
])
def test_kernel_id(name, kid):
    assert counts.kernel_id(name) == kid


def test_unreadable_port_kernel_fails():
    with pytest.raises(counts.UnmappedKernel):
        counts.kernel_id("void s8mma::s8_mma_kernel(signed char const*)")


def _globals(text):
    """Names of the __global__ functions in a CUDA source."""
    names = []
    for m in re.finditer(r"__global__\s+void\s+", text):
        i = m.end()
        if text.startswith("__launch_bounds__", i):
            depth, i = 0, text.index("(", i)
            while True:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
                if depth == 0:
                    break
        names.append(re.match(r"\s*(\w+)", text[i:]).group(1))
    return names


def test_every_global_is_mapped():
    """The map covers every __global__ of the port's CUDA sources."""
    csrc = Path(__file__).resolve().parents[2] / "medplib_tpu_torch" / "csrc"
    names = set()
    for p in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        names.update(_globals(p.read_text()))
    assert names == set(counts.PORT_KERNELS)
