"""Image retrieval for in-context examples (rag/image_rag.py)."""
