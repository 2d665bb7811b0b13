"""An autouse fixture for the port's test modules: when a module's tests
end, drop the JAX side's compiled programs (`jax.clear_caches()`) if the
process maps more than MAP_BUDGET memory regions. tests/test_torch_sharded.py,
whose sharded programs alone map more than half of the limit below, checks
after each test.

Every loaded XLA CPU executable maps memory regions of its own. Kept for
a whole run, the programs of the port's modules and the JAX package's
pile up in each pytest-xdist worker past the kernel's map limit
(vm.max_map_count, 65 530 by default), and the worker's next compile or
persistent-cache read then crashes it. Dropping them only when the budget
is passed keeps recompiles rare. A module imports the fixture by name; it
changes no result, only what stays loaded. This file holds no tests.
"""

import jax
import pytest

MAP_BUDGET = 32_768  # half the kernel's default vm.max_map_count


def release_if_crowded() -> None:
    """jax.clear_caches() when this process maps more than MAP_BUDGET
    regions (nothing where /proc is missing)."""
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > MAP_BUDGET:
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    yield
    release_if_crowded()
