"""Many render contexts and framebuffer bands over a device mesh:
``mesh`` (the port's 1-D mesh of torch devices), ``context_batch`` (the
context axis), ``tile_shard`` (one frame in horizontal bands) and
``dryrun`` (the multi-device dry run)."""
