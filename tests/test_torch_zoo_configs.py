"""The port's config registry against the JAX package's: the same arch
names in the same order, and every config, full and SMOKE, equal field
for field (exact: the configs are literals)."""
import dataclasses

import pytest

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config

from repro_torch.configs import ARCH_NAMES, get_config
from test_torch_threads import torch_threads  # noqa: F401 (autouse)


def test_arch_names_equal_the_reference():
    assert ARCH_NAMES == JARCH_NAMES
    assert len(ARCH_NAMES) == 10


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_config_equals_the_reference(arch, smoke):
    want = dataclasses.asdict(jget_config(arch, smoke=smoke))
    got = dataclasses.asdict(get_config(arch, smoke=smoke))
    assert got == want
