"""The port's row gather (ops/gather.py) against the reference: the plain
version bit for bit against the four Pallas kernels of the gather probe
(tools/probe_pallas_gather.py) run in interpret mode, against jnp's
one-row gather of the packed corner table, and against jnp's clamp of an
index past the end. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py."""

import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_kernel_tpu_torch.ops import gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe(monkeypatch_module):
    """The probe's namespace, run as its own script with --interpret."""
    path = os.path.join(REPO, "tools", "probe_pallas_gather.py")
    monkeypatch_module.setattr(sys, "argv", [path, "--interpret"])
    return runpy.run_path(path)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("kernel", ["k_fancy", "k_take", "k_tala",
                                    "k_onehot"])
def test_plain_gather_matches_probe_kernels(probe, kernel):
    assert probe["INTERPRET"]
    # the 1-D kernels read the (V,) table, the 2-D ones its (V/128, 128)
    # view, as the probe calls them
    tab = probe["TAB"] if kernel in ("k_fancy", "k_take") else probe["TAB2"]
    ref = np.asarray(probe["call"](probe[kernel], tab))
    table = torch.as_tensor(np.array(probe["TAB"]))[:, None]
    idx = torch.as_tensor(np.array(probe["IDX"]))
    out = gather.gather_rows(table, idx)[:, 0].numpy()
    assert out.shape == (probe["L"],)
    np.testing.assert_array_equal(out, ref)


def test_plain_gather_rows_match_jnp():
    rng = np.random.default_rng(3)
    table = rng.random((4096, 8)).astype(np.float32)
    idx = rng.integers(0, 4096, 1000).astype(np.int32)
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    out = gather.gather_rows(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_index_past_the_end_clamps_like_jnp():
    rng = np.random.default_rng(4)
    table = rng.random((64, 8)).astype(np.float32)
    idx = np.asarray([0, 63, 64, 65, 1000, 1 << 30], np.int64)
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    out = gather.gather_rows(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy()[2:], table[[63] * 4])
