__version__ = "0.1.0"  # the JAX package's version (olmoasr_tpu/version.py)
