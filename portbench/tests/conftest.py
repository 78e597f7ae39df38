"""Small sizes for the host: each test run of a cell replaces its
configuration's ``N`` and ``nb`` by ``SMALL``."""

import pytest

from portbench import spec

SMALL = {"N": 256, "nb": 64}


@pytest.fixture(scope="session")
def bench():
    return spec.load()


@pytest.fixture
def small(bench):
    def cfg(cell_name: str) -> dict:
        c = spec.cell(bench, cell_name)
        return {**spec.config(bench, c["config"]), **SMALL}
    return cfg
