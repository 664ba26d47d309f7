"""H100 probes of the training attention (rows 3 and 9 of PERF.md §6), the
port of the TPU timing probes under ``perf/``: ``python -m
olmoasr_tpu_torch.perf.probe_pack|probe_pipe|probe_bwd <variant> ...``."""
