"""Integrations of the PyTorch port with image libraries
(``pil_plugin.py``: Pillow; it imports PIL, which nothing else here
does)."""
