"""Data: conversation templates, tokenization, image preprocessing, the
supervised dataset and its static-shape collator."""
