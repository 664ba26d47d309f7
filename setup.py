from setuptools import find_packages, setup

setup(
    name="olmoasr-tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) speech recognition framework "
    "with the capabilities of allenai/OLMoASR",
    packages=find_packages(
        include=["olmoasr_tpu", "olmoasr_tpu.*", "olmoasr", "olmoasr_tpu_torch*"]
    ),
    # the PyTorch/CUDA port builds its kernels from these sources at first use;
    # its normalizer reads its own spelling asset
    package_data={"olmoasr_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "assets/english.json"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "regex", "scipy", "optax"],
    entry_points={
        "console_scripts": [
            "olmoasr-tpu=olmoasr_tpu.transcribe:cli",
        ],
    },
)
