"""Evaluation: segmentation and VQA metrics, the evaluation loop
(eval/infer.py) and its CLI, MoE gate analysis."""
