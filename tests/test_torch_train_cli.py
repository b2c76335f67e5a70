"""The port's training CLI (medplib_tpu_torch/train/cli.py) on the CPU:
the JAX CLI's flags and defaults (plus --device), two training steps with
per-epoch validation and a --eval-only pass on tiny configs (plain, ICL,
and MoE seeded from donor checkpoints), the stage-4 expert surgery held
leaf for leaf to the JAX CLI's from the same donor directories, and the
mesh / multi-process flags refusing inconsistent settings.

The tokenizer is the offline stub of tests/test_cli.py, patched into
transformers.AutoTokenizer.from_pretrained; images are written from a
numpy seed; every run passes --device cpu."""

import argparse
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import medplib as jm
from medplib_tpu.train import cli as jcli
from medplib_tpu_torch.train import cli as tcli
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import tree as tree_util
from medplib_tpu_torch.utils.checkpoint import save_params
from test_cli import FakeHFTok, fake_tokenizer, tiny_dataset  # noqa: F401
from test_cli_icl import ICL_FLAGS, icl_dataset  # noqa: F401

torch.set_num_threads(1)


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def test_argparser_matches_jax():
    """Every flag of the JAX CLI with its default, plus --device."""
    req = ["--version", "v", "--tokenizer", "t", "--dataset-json", "d",
           "--image-folder", "f"]
    want = vars(jcli.build_argparser().parse_args(req))
    got = vars(tcli.build_argparser().parse_args(req))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("flag", [["--mesh-data", "2"], ["--mesh-expert", "2"],
                                  ["--mesh-model", "2"],
                                  ["--coordinator", "localhost:1234",
                                   "--mesh-data", "2"],
                                  ["--num-processes", "2"]])
def test_mesh_and_multiprocess_flags_raise(flag, fake_tokenizer):  # noqa: F811
    """A mesh that does not match the process count, or several processes
    without a coordinator, stop the process before anything is built (the
    multi-process run itself: tests/test_torch_distributed.py)."""
    with pytest.raises(ValueError, match="processes|coordinator"):
        tcli.main(["--version", "random", "--tokenizer", "fake", "--tiny",
                   "--dataset-json", "x", "--image-folder", "y",
                   "--device", "cpu"] + flag)


def _common(data_json, folder, log_dir, name, val_json=None):
    args = ["--version", "random", "--tokenizer", "fake", "--tiny",
            "--dataset-json", data_json, "--image-folder", folder,
            "--exp-name", name, "--log-base-dir", log_dir,
            "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "1",
            "--model-max-length", "96", "--warmup-steps", "1",
            "--save-steps", "2", "--log-steps", "1", "--precision", "fp32",
            "--device", "cpu"]
    if val_json:
        args += ["--val-data-path", val_json, "--val-batch-size", "2"]
    return args


def _check_run(log_dir, name, out):
    ckpt = os.path.join(log_dir, name, "ckpt_model")
    assert os.listdir(ckpt) == ["2"]
    assert "training done at step 2" in out
    scalars = open(os.path.join(log_dir, name, "scalars.jsonl")).read()
    assert '"train/loss"' in scalars


@pytest.mark.parametrize("workers", ["0", "2"])
def test_train_cli_two_steps_validation_and_eval_only(
        fake_tokenizer, tiny_dataset, tmp_path, capsys, workers):  # noqa: F811
    """Two steps through the prefetching loader, a checkpoint at step 2,
    a validation pass (finite gIoU / cIoU / dice / loss, val/ scalars),
    then --eval-only restores step 2 and validates to the same numbers
    (the val batch of 2 pads the one-record file and clears the pad's
    mask_valid)."""
    data_json, folder = tiny_dataset
    log_dir = str(tmp_path / "runs")
    args = _common(data_json, folder, log_dir, "plain", data_json) + [
        "--workers", workers]
    assert tcli.main(args) == 2
    out = capsys.readouterr().out
    _check_run(log_dir, "plain", out)
    val = [s for s in out.splitlines() if "val:" in s][-1]
    scalars = open(os.path.join(log_dir, "plain", "scalars.jsonl")).read()
    assert '"val/giou"' in scalars and '"val/dice"' in scalars
    res = tcli.main(args + ["--eval-only"])
    out = capsys.readouterr().out
    assert "eval_only @ step 2:" in out
    assert all(np.isfinite(v) for v in res.values())
    assert val.split("val: ")[1] == out.strip().split("step 2: ")[1]


def test_train_cli_icl(fake_tokenizer, icl_dataset, tmp_path,  # noqa: F811
                       capsys):
    """The ICL stage (separate masks, mask encoder, token compressor, the
    ICL recipe's sft modules) trains two steps with validation, then
    --eval-only; --no-eval skips the pass."""
    data_json, val_json, folder = icl_dataset
    log_dir = str(tmp_path / "runs")
    args = _common(data_json, folder, log_dir, "icl", val_json) + [
        "--workers", "0", "--sft-modules",
        "mask_decoder,text_hidden_fcs,mm_token_compressor,mask_encoder",
    ] + ICL_FLAGS
    tcli.main(args)
    out = capsys.readouterr().out
    _check_run(log_dir, "icl", out)
    assert "epoch 0 val: giou=" in out
    tcli.main(args + ["--eval-only"])
    assert "eval_only @ step 2:" in capsys.readouterr().out
    tcli.main(_common(data_json, folder, str(tmp_path / "r2"), "icl2",
                      val_json) + ["--workers", "0", "--no-eval"]
              + ICL_FLAGS)
    assert "val:" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# stage 4: experts from donor checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
def test_seed_experts_from_donors_matches_jax(tmp_path, residual):
    """_seed_experts_from_donors on the same tree and donor directories
    (chip_smoke.write_donors: a tiny LLaMA each; donor 0 also
    text_hidden_fcs and a SAM mask decoder, donor 1 a region adapter):
    every leaf equal to the JAX CLI's (experts [L, E, in, out] from the
    donors' MLPs, text_hidden_fcs and the mask decoder from donor 0, the
    region adapter from donor 1, the residual copy re-seeded from the
    tree's dense MLP)."""
    cfg = jc.MedplibConfig.tiny(moe=jc.MoeConfig(
        enable=True, num_experts=2, use_residual=residual))
    paths = cs.write_donors(str(tmp_path), port_cfg(cfg))
    args = argparse.Namespace(expert_pretrained_path=paths)
    jp = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    tp = convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    want = jcli._seed_experts_from_donors(args, cfg, jp)
    got = tcli._seed_experts_from_donors(args, port_cfg(cfg), tp, "cpu")
    wl = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
          for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    gl = dict(tree_util.leaves_with_paths(got))
    assert set(gl) == set(wl)
    for path, g in gl.items():
        w = np.asarray(wl[path], np.float32)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.float().numpy(), w, err_msg=str(path))
    ex = got["llm"]["layers"]["moe"]["experts"]["gate_proj"]["kernel"]
    assert tuple(ex.shape) == (cfg.llm.num_layers, 2, cfg.llm.hidden_size,
                               cfg.llm.intermediate_size)


def test_train_cli_moe_from_donors(fake_tokenizer, tiny_dataset,  # noqa: F811
                                   tmp_path, capsys):
    """Stage 4 at --tiny: a saved tree (save_params) as --version, the
    experts seeded from two donor directories, top-1 at capacity 1.5,
    two steps with validation, then --eval-only. The checkpoint's experts
    equal the donors' MLPs (frozen under LoRA)."""
    data_json, folder = tiny_dataset
    tok = FakeHFTok()
    from medplib_tpu_torch.data import tokenize as tk
    tk.add_special_tokens(tok)
    moe = tc.MoeConfig(enable=True, num_experts=2, top_k=1)
    cfg = tc.tiny_cli_config(moe, tok.convert_tokens_to_ids("<SEG>"),
                             len(tok))
    from medplib_tpu_torch.models import medplib as tm
    tree = tm.init_medplib(torch.Generator().manual_seed(1), cfg,
                           torch.float32, "cpu")
    version = str(tmp_path / "stage3.pt")
    save_params(version, tree)
    donors = cs.write_donors(str(tmp_path), cfg)
    log_dir = str(tmp_path / "runs")
    args = _common(data_json, folder, log_dir, "moe", data_json)
    args[1] = version
    args += ["--moe-enable", "--expert-pretrained-path", donors,
             "--workers", "2"]
    tcli.main(args)
    out = capsys.readouterr().out
    _check_run(log_dir, "moe", out)
    assert "epoch 0 val: giou=" in out
    res = tcli.main(args + ["--eval-only"])
    assert all(np.isfinite(v) for v in res.values())
    assert "eval_only @ step 2:" in capsys.readouterr().out
    state = torch.load(os.path.join(log_dir, "moe", "ckpt_model", "2",
                                    "state.pt"), weights_only=True)
    gate = state["params"]["llm"]["layers"]["moe"]["experts"]["gate_proj"]
    for e, d in enumerate(donors.split(",")):
        sd = torch.load(os.path.join(d, "pytorch_model.bin"),
                        weights_only=True)
        want = torch.stack([sd[f"model.layers.{i}.mlp.gate_proj.weight"].t()
                            for i in range(cfg.llm.num_layers)])
        assert torch.equal(gate["kernel"][:, e], want)
