"""Test configuration: force a virtual 8-device CPU JAX backend.

The tests run on the CPU, with or without a GPU in the machine: this file
sets jax_platforms to cpu in the live config before any backend
initializes (an environment variable alone would lose to a JAX_PLATFORMS
already set, or to jax imported before this file).  Multi-device sharding is
validated on a simulated 8-device mesh exactly as SURVEY.md §4 prescribes.
The program runs on the GPU through its own entry points (cli.py, bench.py,
chip_smoke.py), never through these tests.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_mesh():
    assert jax.default_backend() == "cpu", (
        "tests must run on the virtual CPU backend; jax backend was "
        f"initialized to {jax.default_backend()} before conftest could "
        "force cpu"
    )
    assert len(jax.devices()) == 8


@pytest.fixture(scope="session")
def small_t7_fastq():
    """Checked-in seeded synthetic reads (1000 reads of 150-250 bases plus
    a 10-40 base polyA tail: tools/generate_fake_sequences.py --reads 1000
    --seed 7 --min-len 150 --max-len 250 --polya-min 10 --polya-max 40)."""
    return DATA / "golden.1000.fastq"


@pytest.fixture(scope="session")
def small_t7_golden():
    """Its k=14 golden counts (tools/make_golden.py --k 14)."""
    return DATA / "golden.1000.fastq.14.count"
