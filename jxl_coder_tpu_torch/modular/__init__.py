"""The port's Modular inverse transforms (``device``) and output
(``output``)."""
