"""The JPEG routes' device layer: ``pixels`` (kernels J1 and J2),
``wire`` (a chroma-subsampled recompressed JPEG) and ``transcode`` (the
round-1 private container)."""
