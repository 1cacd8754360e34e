"""Multi-device decode and encode over torch.distributed ranks: the
block-row and frame-axis sharding of ``groups``, the GOP decode and
encode of ``multihost`` and the dry runs of ``dryrun``."""
