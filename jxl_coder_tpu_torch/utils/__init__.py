"""Tracing and logging of the PyTorch port (``utils/trace.py``)."""
