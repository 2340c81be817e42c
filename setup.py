"""Package metadata + the ``accelerate-tpu`` console entry (reference ``setup.py``)."""

from setuptools import find_packages, setup

setup(
    name="accelerate_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/pjit/Pallas) training & inference framework with the "
    "capabilities of HuggingFace Accelerate",
    packages=find_packages(include=["accelerate_tpu", "accelerate_tpu.*",
                                   "accelerate_tpu_torch", "accelerate_tpu_torch.*"]),
    package_data={"accelerate_tpu.native": ["*.cpp"], "accelerate_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax", "orbax-checkpoint", "safetensors", "pyyaml", "packaging"],
    entry_points={
        "console_scripts": [
            "accelerate-tpu = accelerate_tpu.commands.accelerate_cli:main",
            "accelerate-tpu-launch = accelerate_tpu.commands.launch:main",
        ]
    },
)
