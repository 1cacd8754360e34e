"""The port's device entropy decode (``device``)."""
