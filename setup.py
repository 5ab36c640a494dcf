from setuptools import setup, find_packages

setup(
    name="nf_tpu",
    version="0.1.0",
    description="TPU-native neural importance sampling with normalizing flows",
    packages=find_packages(include=["nf_tpu", "nf_tpu.*",
                                    "nf_tpu_torch", "nf_tpu_torch.*"]),
    package_data={"nf_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
)
