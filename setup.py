"""Packaging (reference: DeepSpeed ``setup.py`` + ``op_builder`` AOT flags).

TPU-native build: the compute path is pure JAX/Pallas (no AOT CUDA arches),
and the native host ops (AVX CPUAdam, async disk I/O) compile lazily at
import via the C toolchain (see ``deepspeed_tpu/ops/native/build.py``) —
the JIT path of the reference's op_builder. ``DS_BUILD_NATIVE=1`` forces
them to compile at install time instead.

The PyTorch/CUDA port ``deepspeed_tpu_torch`` ships its ``csrc/*.cu``
kernels as sources; they build with nvcc at first use on the card.
"""

import os

from setuptools import find_packages, setup

version = "0.1.0"

if os.environ.get("DS_BUILD_NATIVE", "0") == "1":
    try:
        from deepspeed_tpu.ops.native.build import build_all

        build_all()
    except Exception as e:  # pragma: no cover - best effort AOT
        print(f"warning: native op AOT build failed ({e}); ops build lazily at import")

setup(
    name="deepspeed_tpu",
    version=version,
    description="TPU-native distributed training and inference framework",
    packages=find_packages(
        include=["deepspeed_tpu", "deepspeed_tpu.*", "deepspeed_tpu_torch", "deepspeed_tpu_torch.*"]
    ),
    include_package_data=True,
    # the PyTorch/CUDA port: its kernels ship as sources and build with nvcc at first use
    package_data={"deepspeed_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    scripts=[
        "bin/deepspeed",
        "bin/ds_report",
        "bin/ds_bench",
        "bin/ds_ssh",
        "bin/ds_elastic",
    ],
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pydantic>=2",
    ],
    python_requires=">=3.10",
)
