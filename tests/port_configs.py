"""Helpers of the port's tests.

``to_port`` builds the port's config from the JAX package's through one
dict: the JAX ``config_to_dict`` on one side and the port's
``config_from_dict`` on the other, so a test hands each package its own
config.

``one_torch_thread`` is an autouse fixture for the files that hold the
port's plain versions to exact or tight limits (import it into the test
module): each test runs with one intra-op thread.  Under the suite's six
workers on eight cores, a comparison of two identical plain-version calls
once differed in one eighth of its outputs (280 of 2304: the 288 outputs
of one of the eight 96-row blocks that 8 threads split a 768-row float32
GEMM into), and another file's first case failed its limit against JAX
the same way; alone, either passes.  On one thread every product of a
test runs on the calling thread, so per-thread state and partitioning
cannot split a result.
"""

import pytest
import torch

from spatialvae_tpu.core import config as jax_config

from spatialvae_torch import config as port_config


def to_port(cfg):
    return port_config.config_from_dict(jax_config.config_to_dict(cfg))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
