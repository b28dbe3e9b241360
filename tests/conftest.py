"""Test harness: an 8-device virtual CPU mesh unless a platform is named.

Mirrors SURVEY.md §4's rebuild test strategy: multi-device sharding is
validated on a virtual mesh via ``--xla_force_host_platform_device_count=8``
(the JAX analogue of multi-node tests without a cluster).  Tests run on the
CPU for speed and determinism.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX's platform is not a GPU.  Run them on a
GPU host with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (or
through ``python chip_smoke.py``, whose kernel phase runs them).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, never at
    import or collection)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX platform "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.fixture
def tiny_vocab():
    from icee_tpu.data.vocab import SPECIALS, Vocabulary

    v = Vocabulary()
    for s in SPECIALS:
        v.add_word(s)
    for w in ["seorang", "anak", "bermain", "bola", "di", "lapangan", "anjing",
              "berlari", "dengan", "senang"]:
        v.add_word(w)
    return v
