"""witch-tpu: TPU-native WITCH (WeIghTed Consensus Hmm alignment).

Builds the native host kernels (C++, CPython C API) alongside the pure
Python/JAX package. The native extension is optional at runtime — modules
fall back to numpy implementations when it is absent.
"""

import numpy
from setuptools import Extension, find_packages, setup

setup(
    name="witch-tpu",
    version="0.1.0",
    description="TPU-native WITCH multiple sequence alignment",
    packages=find_packages(include=["witch_tpu", "witch_tpu.*",
                                    "witch_tpu_torch", "witch_tpu_torch.*"]),
    # the port's CUDA and native C++ sources ship as data: they are
    # compiled at first use (witch_tpu_torch/_build.py by nvcc on a CUDA
    # host, witch_tpu_torch/native/__init__.py by the C++ compiler),
    # never here
    package_data={"witch_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "native/*.cpp", "native/*.h"]},
    ext_modules=[
        Extension(
            "witch_tpu.native._oa",
            sources=["witch_tpu/native/oa_kernel.cpp"],
            include_dirs=[numpy.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-march=native",
                                "-funroll-loops"],
        ),
        Extension(
            "witch_tpu.native._pairhmm",
            sources=["witch_tpu/native/pairhmm_kernel.cpp"],
            include_dirs=[numpy.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-march=native",
                                "-funroll-loops"],
        ),
        Extension(
            "witch_tpu.native._domaindef",
            sources=["witch_tpu/native/domaindef_kernel.cpp"],
            include_dirs=[numpy.get_include()],
            # fp-contract=off: the exact-f32 trace engine (stoch_f32.h)
            # reproduces the reference binary's separate mulps/addps
            # rounding; FMA contraction would change the value stream.
            extra_compile_args=["-O3", "-std=c++17", "-march=native",
                                "-funroll-loops", "-ffp-contract=off"],
        ),
    ],
    python_requires=">=3.10",
    install_requires=["numpy", "scipy", "jax"],
    entry_points={
        "console_scripts": ["witch-tpu=witch_tpu:witch_runner"],
    },
)
