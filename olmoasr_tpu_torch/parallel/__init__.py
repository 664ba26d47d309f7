"""Multi-rank training: the process group and the (data, fsdp) device mesh."""
