"""medplib_tpu_torch — the PyTorch + CUDA port of medplib_tpu for NVIDIA Hopper.

The JAX package `medplib_tpu` is the reference; this package mirrors its
layout and function names so each counterpart is easy to find:

  config          the model and training dataclasses (equal to
                  medplib_tpu's), the flagship configuration, with_icl
  ops             norms / rope / attention / splice / moe / sampling
                  (plain torch)
  ops/cuda        wrappers of the hand-written Hopper kernels (csrc/*.cu),
                  each with its plain PyTorch version beside it
  models          llama / moe_llama / clip / projector (+ ICL compressor,
                  mask encoder, region pooling) / geo_sampler / sam_med2d
                  / losses / medplib (generate, model_forward); the SAM
                  predictor and automatic mask generation (sam_predictor,
                  amg)
  train           lora (linears, injection, dropout, trainable mask,
                  merge), optimizer (AdamW to optax's semantics), trainer
  data            conversation templates, tokenization, image
                  preprocessing (numpy), the supervised dataset, collate
  eval            segmentation and VQA metrics, the evaluation loop
                  and its CLI, MoE gate analysis
  rag             CLIP-embedding image retrieval of in-context examples
  serve           the continuous-batching engine, the wire protocol and
                  its PNG codec, controller, model worker, web UI
  chat            the interactive chat CLI
  utils           released-checkpoint loader (hf_weights, export) and its
                  inverse (hf_export), weight bridge (convert),
                  quantization, tree views, checkpoints, logging
  parallel        the (data, expert, model) mesh over torch.distributed,
                  sharding rules, tensor parallelism, rank pools and the
                  multi-process dry run
  native          the C++ preprocessing library (built at first use)

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
