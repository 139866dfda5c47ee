"""Packaging: `pip install .` -> vapor-tpu console script.

Replaces the reference's setuptools+cythonize build (setup.py:12-24);
the native component here is the C++ BAM codec, compiled on first use
(vapor_tpu/native), so no build-time extension step is required.
"""
from setuptools import find_packages, setup

setup(
    name="vapor-tpu",
    version="0.1.0",
    description="TPU-native long-read validation of structural variants "
                "(VaPoR-compatible)",
    packages=find_packages(include=["vapor_tpu", "vapor_tpu.*",
                                    "vapor_tpu_torch", "vapor_tpu_torch.*"]),
    package_data={"vapor_tpu": ["native/*.cpp",
                                "engine/autotune_tables/*.json"],
                  "vapor_tpu_torch": ["engine/kernels/csrc/*.cu",
                                      "engine/kernels/csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy", "scipy", "matplotlib", "scikit-learn", "jax",
    ],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": ["vapor-tpu=vapor_tpu.cli:main",
                            "vapor-tpu-torch=vapor_tpu_torch.cli:main"],
    },
)
