"""The benchmark of the PyTorch and CUDA port (``olmoasr_tpu_torch``) on one
NVIDIA H100: ``python3 gpubench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``, driven by ``BENCHMARK.json`` at the root of
the checkout."""
