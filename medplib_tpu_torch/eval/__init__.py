"""Evaluation: segmentation metrics (eval/seg_metrics.py)."""
