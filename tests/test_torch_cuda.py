"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs.  Every test here needs a CUDA device and
skips without one; the file imports no JAX, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the Z_2^32 share-sum is exact; the float MPC round within
atol = P * 1e-6 (the plain version sums the pads exactly in float64 and
rounds once, the kernel in float32 pair by pair); the DP noise within rtol = 1e-5, atol = 1e-6 (log / cos of the
card's libm against PyTorch's).
"""
import numpy as np
import pytest
import torch

from repro_torch.chaos.harness import CNNFederation
from repro_torch.pytree import tree_flatten
from repro_torch.kernels.dp import kernel as dp_kernel
from repro_torch.kernels.dp import ref as dp_ref
from repro_torch.kernels.secure_agg import kernel as agg_kernel
from repro_torch.kernels.secure_agg import ref as agg_ref
from repro_torch.privacy.accountant import DPConfig

MASKS = ["all", "one_dead", "two_dead"]
MODES = ["float", "int", "dp"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(P, N, mask_kind, device, seed=0):
    rng = np.random.default_rng([seed, P, N, MASKS.index(mask_kind)])
    u = rng.standard_normal((P, N)).astype(np.float32)
    mask = None
    if mask_kind != "all":
        mask = np.ones(P, np.float32)
        dead = [P - 1] if mask_kind == "one_dead" else [0, P // 2]
        mask[dead] = 0.0
        u[dead[0]] = np.inf
        if len(dead) > 1:
            u[dead[1]] = np.nan
        mask = torch.from_numpy(mask).to(device)
    return torch.from_numpy(u).to(device), mask


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 4097, 109634])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", [2, 10, 16])
def test_secure_agg_kernels_match_plain(cuda, P, N, mask_kind):
    u, m = _case(P, N, mask_kind, cuda)
    before = agg_kernel.masked_field_wsum_flat.launches
    words = agg_kernel.masked_field_wsum_flat(u, 99, m)
    assert agg_kernel.masked_field_wsum_flat.launches == before + 1
    assert words.dtype == torch.int32
    assert torch.equal(words, agg_ref.masked_field_wsum_reference(u, 99, m))
    before = agg_kernel.masked_rolling_update_flat.launches
    out = agg_kernel.masked_rolling_update_flat(u, 99, 0.7, m)
    assert agg_kernel.masked_rolling_update_flat.launches == before + 1
    want = agg_ref.masked_rolling_update_reference(u, 99, 0.7, m)
    torch.testing.assert_close(out, want, atol=P * 1e-6, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 4097, 109634])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_dp_kernel_matches_plain(cuda, N, mask_kind):
    u, m = _case(10, N, mask_kind, cuda)
    norms = dp_ref._row_norms(u)
    before = dp_kernel.clip_noise_flat.launches
    out = dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
    assert dp_kernel.clip_noise_flat.launches == before + 1
    want = dp_ref.clip_noise_reference(u, 5, 0.5, 1.0, m, norms)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    u = torch.zeros((3, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        agg_kernel.masked_rolling_update_flat(u.double(), 1, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        agg_kernel.masked_field_wsum_flat(u.t().contiguous().t(), 1)
    with pytest.raises(ValueError, match="1 <= P <= 16"):
        dp_kernel.clip_noise_flat(torch.zeros((17, 8), device=cuda),
                                  torch.ones((17, 1), device=cuda),
                                  1, 1.0, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_federation_on_card_matches_cpu(cuda, mode):
    """The same small federation on the card (through the kernels) and on
    the CPU (through the plain versions): loss within rtol = 1e-4, params
    within atol = 1e-4."""
    kw = dict(n_institutions=3, image_size=16, width_scale=0.25,
              secure_domain="int" if mode == "int" else "float",
              dp=DPConfig(0.5, 1.0) if mode == "dp" else None)
    cpu = CNNFederation(None, 0, device="cpu", **kw)
    gpu = CNNFederation(None, 0, device=cuda, **kw)
    kernel = (agg_kernel.masked_field_wsum_flat if mode == "int"
              else agg_kernel.masked_rolling_update_flat)
    before = kernel.launches
    cm, _ = cpu.run_rounds(2)
    gm, _ = gpu.run_rounds(2)
    assert kernel.launches == before + 2
    np.testing.assert_allclose(gm["loss"].cpu().numpy(), cm["loss"].numpy(),
                               rtol=1e-4)
    for a, b in zip(tree_flatten(gpu.stacked)[0],
                    tree_flatten(cpu.stacked)[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
    assert gpu.overlay.registry.verify_log()
