"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding logic is exercised without accelerator hardware (SURVEY §4:
multi-device tests runnable on CPU via xla_force_host_platform_device_count).

Code fixtures are built with ``construct_code`` (bit-exact against the
reference's code files, tests/test_construction.py); file-based tests read
files these fixtures write."""

import os

# Force CPU even when the environment preselects an accelerator platform.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA's CPU backend has segfaulted inside backend_compile_and_load /
    executable serialization after ~130 tests' worth of accumulated compiled
    programs (observed twice at different suite positions, never in any
    subset run).  Dropping executable references between modules keeps the
    live-compilation footprint bounded; reruns within a module still hit the
    in-memory cache."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def small_code():
    from qec_ldpc.codes import construct_code

    return construct_code(3, 3, 6, 7, 2, 3)


@pytest.fixture(scope="session")
def code610():
    from qec_ldpc.codes import construct_code

    return construct_code(4, 5, 10, 61, 9, 49)


@pytest.fixture(scope="session")
def small_graphs(small_code):
    from qec_ldpc.decoder import CodeGraphs

    return CodeGraphs.build(small_code)


@pytest.fixture(scope="session")
def small_code_file(small_code, tmp_path_factory):
    """The [[42]] code in the reference's 4-line file format, under the
    reference's own file name."""
    from qec_ldpc.codes.loader import save_code_file

    path = tmp_path_factory.mktemp("codes") / "J_3_K_3_L_6_P_7_s_2_t_3.txt"
    save_code_file(small_code, str(path))
    return str(path)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
