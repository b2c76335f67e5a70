"""Serving: the continuous-batching engine (serve/engine.py), the wire
protocol (serve/protocol.py, with its PNG codec serve/png.py), the
controller, the model worker and the web UI."""
