"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs.  Every test here needs a CUDA device and
skips without one; the file imports no JAX, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the Z_2^32 share-sums (fused and legacy) are exact; the float
MPC round within atol = P * 1e-6 (the plain version sums the pads exactly
in float64 and rounds once, the kernel in float32 pair by pair); the
legacy float aggregate within atol = P * 1e-6 plus one ulp of the output
type (2^-7 relative in bf16, 2^-10 in f16: the two sum the P shares in
another order, and torch divides a tensor by a scalar as a multiply by
its reciprocal); the DP noise within rtol = 1e-5, atol = 1e-6 (log / cos of the
card's libm against PyTorch's); flash attention within atol = rtol =
2e-2 in bf16 and 2e-5 in fp32 (the JAX package's own bounds for its
kernel against its plain version: the kernel sums in another order and
rescales online); the WKV6 and selective-scan kernels within atol =
rtol = 2e-2 for bf16 y and 1e-4 of the largest magnitude for fp32 y and
the fp32 states (they sum in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.chaos.harness import CNNFederation
from repro_torch.pytree import tree_flatten
from repro_torch.kernels.dp import kernel as dp_kernel
from repro_torch.kernels import _cuda
from repro_torch.kernels.dp import ref as dp_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
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


# ----------------------------------------------------------------------
# the legacy two-stage round's aggregates: any P, ragged N, narrow params

LEGACY_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
              torch.float16: 2.0 ** -10}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("N", [1, 3, 255, 4097, 109634])
@pytest.mark.parametrize("P", [1, 2, 10, 17])
def test_legacy_kernels_match_plain(cuda, P, N, dtype):
    g = torch.Generator(cuda).manual_seed(P * 100003 + N)
    shares = torch.randn((P, N), generator=g, device=cuda)
    params = torch.randn((N,), generator=g, device=cuda).to(dtype)
    for alpha in (1.0, 0.3):
        before = agg_kernel.rolling_update_flat.launches
        out = agg_kernel.rolling_update_flat(shares, params, alpha)
        assert agg_kernel.rolling_update_flat.launches == before + 1
        assert out.dtype == dtype and out.shape == (N,)
        want = agg_ref.rolling_update_reference(shares, params, alpha)
        torch.testing.assert_close(out.float(), want.float(), atol=P * 1e-6,
                                   rtol=LEGACY_ULP[dtype])
    words = torch.randint(-2 ** 31, 2 ** 31, (P, N), generator=g,
                          device=cuda, dtype=torch.int64).to(
        torch.int32).view(torch.uint32)
    before = agg_kernel.field_wsum_flat.launches
    wsum = agg_kernel.field_wsum_flat(words)
    assert agg_kernel.field_wsum_flat.launches == before + 1
    assert wsum.dtype == torch.int32 and wsum.shape == (N,)
    assert torch.equal(wsum, agg_ref.field_wsum_reference(words))


def _at_offset(t, k):
    """A contiguous copy of `t` that starts k elements into its storage."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_legacy_kernels_take_offset_views(cuda, k, dtype):
    """N % 4 == 0, but the operands start off a 16-byte boundary: the
    kernels take the scalar path and agree with the plain versions."""
    P, N = 3, 4096
    g = torch.Generator(cuda).manual_seed(k)
    shares = torch.randn((P, N), generator=g, device=cuda)
    params = torch.randn((N,), generator=g, device=cuda).to(dtype)
    want = agg_ref.rolling_update_reference(shares, params, 0.3)
    for sh, pa in ((_at_offset(shares, k), params),
                   (shares, _at_offset(params, k)),
                   (_at_offset(shares, k), _at_offset(params, k))):
        out = agg_kernel.rolling_update_flat(sh, pa, 0.3)
        torch.testing.assert_close(out.float(), want.float(), atol=P * 1e-6,
                                   rtol=LEGACY_ULP[dtype])
    words = shares.view(torch.uint32)
    wsum = agg_kernel.field_wsum_flat(_at_offset(words, k))
    torch.cuda.synchronize()
    assert torch.equal(wsum, agg_ref.field_wsum_reference(words))


@pytest.mark.cuda
def test_legacy_wrappers_raise_instead_of_falling_back(cuda):
    shares = torch.zeros((3, 8), device=cuda)
    params = torch.zeros((8,), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        agg_kernel.rolling_update_flat(shares.double(), params, 1.0)
    with pytest.raises(ValueError, match="params must be float32"):
        agg_kernel.rolling_update_flat(shares, params.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        agg_kernel.rolling_update_flat(shares.t().contiguous().t(), params,
                                       1.0)
    with pytest.raises(ValueError, match="contiguous"):
        agg_kernel.rolling_update_flat(
            shares, torch.zeros((16,), device=cuda)[::2], 1.0)
    with pytest.raises(ValueError, match=r"params must be \(8,\)"):
        agg_kernel.rolling_update_flat(shares, params[:4], 1.0)
    words = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint32"):
        agg_kernel.field_wsum_flat(words)
    with pytest.raises(ValueError, match="contiguous"):
        agg_kernel.field_wsum_flat(
            words.t().contiguous().t().view(torch.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["float", "int"])
def test_legacy_round_on_card_matches_cpu(cuda, domain):
    """`secure_rolling_update` on the card (the masks drawn there, one
    kernel launch) against the CPU run: the int round exactly at P = 4,
    alpha = 1; the float round within atol = P * 1e-5 (the normals come
    from each device's erfinv, and the pads cancel to fp32 rounding)."""
    from repro_torch import random as prng
    from repro_torch.core.secure_agg import secure_rolling_update
    P, N = 4, 100_003
    g = torch.Generator().manual_seed(5)
    ups = [torch.randn(N, generator=g) for _ in range(P)]
    params = torch.randn(N, generator=g)
    key = prng.PRNGKey(17)
    kernel = (agg_kernel.field_wsum_flat if domain == "int"
              else agg_kernel.rolling_update_flat)
    before = kernel.launches
    got = secure_rolling_update([u.to(cuda) for u in ups], params.to(cuda),
                                1.0, key, domain=domain)
    assert kernel.launches == before + 1
    want = secure_rolling_update(ups, params, 1.0, key, domain=domain)
    if domain == "int":
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=P * 1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["churn", "quorum_loss"])
def test_fault_run_on_card_matches_cpu(cuda, scenario):
    """A small federation under a fault schedule on the card and on the
    CPU: the same survivor lists and commits, params within atol = 1e-4,
    and the masked kernel launched once a round."""
    from repro_torch.chaos import standard_scenarios
    kw = dict(n_institutions=5, image_size=16, width_scale=0.25)
    sched = standard_scenarios(0)[scenario]
    cpu = CNNFederation(sched, 0, device="cpu", **kw)
    gpu = CNNFederation(sched, 0, device=cuda, **kw)
    before = agg_kernel.masked_rolling_update_flat.launches
    _, ctrs = cpu.run_rounds(6)
    _, gtrs = gpu.run_rounds(6)
    assert agg_kernel.masked_rolling_update_flat.launches == before + 6
    assert [t.survivors for t in gtrs] == [t.survivors for t in ctrs]
    assert [t.committed for t in gtrs] == [t.committed for t in ctrs]
    for a, b in zip(tree_flatten(gpu.stacked)[0],
                    tree_flatten(cpu.stacked)[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


# ----------------------------------------------------------------------
# flash attention: the smoke's shapes, (B, S, Hq, Hkv, hd, dtype, causal,
# window)
FLASH_CASES = [
    (1, 1000, 16, 8, 128, torch.bfloat16, True, 0),   # qwen3, ragged S
    (2, 192, 6, 3, 32, torch.bfloat16, True, 0),
    (2, 192, 6, 3, 32, torch.float32, True, 0),
    (1, 512, 4, 1, 80, torch.bfloat16, True, 0),
    (2, 256, 15, 5, 64, torch.bfloat16, True, 0),
    (2, 256, 4, 2, 64, torch.float32, True, 16),
    (2, 256, 4, 2, 64, torch.float32, True, 64),
    (2, 256, 4, 2, 64, torch.float32, True, 100),
    (1, 200, 4, 2, 64, torch.float32, False, 0),      # non-causal ragged
    (1, 1152, 25, 5, 64, torch.bfloat16, True, 1024),  # hymba's prefill
]


def _flash_inputs(B, S, Hq, Hkv, hd, dtype, device, seed=0):
    rng = np.random.default_rng([seed, B, S, Hq, Hkv, hd])
    return [torch.from_numpy(rng.standard_normal(
        (B, S, h, hd)).astype(np.float32)).to(device=device, dtype=dtype)
        for h in (Hq, Hkv, Hkv)]


def _flash_plain(q, k, v, causal, window):
    return fa_ref.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, case):
    B, S, Hq, Hkv, hd, dtype, causal, window = case
    q, k, v = _flash_inputs(B, S, Hq, Hkv, hd, dtype, cuda)
    before = fa_kernel.flash_attention_bhsd.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_bhsd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, causal, window).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_kernel_layout_entry_and_empty_rows(cuda):
    """The (B, H, S, hd) entry on contiguous inputs, with Sq > Skv under a
    window, so that some q rows have no key to attend to (they are 0)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 2, s, 64)).astype(np.float32)).to(cuda) for s in (96, 40, 40))
    out = fa_kernel.flash_attention_bhsd(q, k, v, causal=True, window=8)
    want = fa_ref.attention_reference(q, k, v, causal=True, window=8)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    assert bool((out[:, :, 48:] == 0).all())


@pytest.mark.cuda
def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.flash_attention_bhsd(*(torch.zeros((1, 2, 8, 48),
                                                     device=cuda),) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bhsd(q, q.cpu(), q)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_bhsd(*(q.half(),) * 3)
    with pytest.raises(ValueError, match="unit stride"):
        fa_kernel.flash_attention_bhsd(q, q.transpose(2, 3), q)


@pytest.mark.cuda
def test_every_source_builds_into_its_own_library(cuda):
    paths = {name: p for name, (p, _) in _cuda.build_all().items()}
    assert set(paths) == set(_cuda.SOURCES) == {
        "secure_agg", "flash_attention", "wkv6", "ssm_scan"}
    assert len({p.name for p in paths.values()}) == len(paths)
    assert all(p.exists() for p in paths.values())
    assert "-fmad=false" in _cuda.nvcc_flags("secure_agg")
    for name in ("flash_attention", "wkv6", "ssm_scan"):
        assert "-fmad=false" not in _cuda.nvcc_flags(name)


# ----------------------------------------------------------------------
# the recurrences: WKV6 (B, T, H, hd, r/k/v dtype, w dtype, nonzero s0,
# strided) and the selective scan (Bz, T, di, N, dtype, nonzero h0), the
# smoke's shapes; bf16 y within atol = rtol = 2e-2 (the flash kernel's
# bound), fp32 y and the fp32 states within 1e-4 of the largest magnitude
# (the kernels sum in another order than the plain versions)
WKV6_CASES = [
    (1, 1000, 40, 64, torch.bfloat16, torch.float32, False, False),
    (8, 1, 40, 64, torch.bfloat16, torch.float32, True, False),
    (2, 77, 4, 32, torch.float32, torch.float32, True, False),
    (2, 40, 3, 16, torch.bfloat16, torch.bfloat16, True, False),
    (1, 33, 2, 128, torch.float32, torch.float32, True, False),
    (2, 50, 4, 64, torch.bfloat16, torch.float32, True, True),
]
SSM_CASES = [
    (1, 1152, 3200, 16, torch.float32, False),
    (8, 1, 3200, 16, torch.float32, True),
    (2, 100, 1001, 16, torch.float32, True),
    (2, 70, 515, 8, torch.bfloat16, True),
    (1, 37, 96, 5, torch.float32, True),
]


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _check_y(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    else:
        assert _rel(got, want) <= 1e-4


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV6_CASES, ids=str)
def test_wkv6_kernel_matches_plain(cuda, case):
    B, T, H, hd, dtype, wdtype, s0_nz, strided = case
    rng = np.random.default_rng([B, T, H, hd])
    if strided:
        r = _randn(rng, B, H, T, hd).to(cuda, dtype).transpose(1, 2)
        v = _randn(rng, B, T, 2 * H, hd).to(cuda, dtype)[:, :, ::2]
    else:
        r = _randn(rng, B, T, H, hd).to(cuda, dtype)
        v = _randn(rng, B, T, H, hd).to(cuda, dtype)
    k = _randn(rng, B, T, H, hd).to(cuda, dtype)
    w = torch.exp(-torch.exp(_randn(rng, B, T, H, hd) - 1)).to(cuda, wdtype)
    u = (_randn(rng, H, hd) * 0.1).to(cuda)
    s0 = (_randn(rng, B, H, hd, hd) * (0.5 if s0_nz else 0.0)).to(cuda)
    before = wkv_kernel.wkv6_bthd.launches
    y, s = wkv_kernel.wkv6_bthd(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv_kernel.wkv6_bthd.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    y_ref, s_ref = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
    _check_y(y, y_ref, dtype)
    assert _rel(s, s_ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_ssm_scan_kernel_matches_plain(cuda, case):
    Bz, T, di, N, dtype, h0_nz = case
    rng = np.random.default_rng([Bz, T, di, N])
    a = torch.sigmoid(_randn(rng, Bz, T, di) + 2).to(cuda, dtype)
    bx = _randn(rng, Bz, T, di).to(cuda, dtype)
    Bm, Cm = (_randn(rng, Bz, T, N).to(cuda, dtype) for _ in range(2))
    h0 = (_randn(rng, Bz, di, N) * (1.0 if h0_nz else 0.0)).to(cuda)
    before = ssm_kernel.ssm_scan_btd.launches
    y, h = ssm_ops.ssm_scan(a, bx, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert ssm_kernel.ssm_scan_btd.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y_ref, h_ref = ssm_ref.ssm_scan_reference(a, bx, Bm, Cm, h0)
    _check_y(y, y_ref, dtype)
    assert _rel(h, h_ref) <= 1e-4


@pytest.mark.cuda
def test_recurrence_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((1, 4, 2, 64), device=cuda, dtype=torch.bfloat16)
    w, u = x.float(), torch.zeros((2, 64), device=cuda)
    s0 = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        y = torch.zeros((1, 4, 2, 48), device=cuda)
        wkv_kernel.wkv6_bthd(y, y, y, y, u[:, :48].contiguous(),
                             s0[:, :, :48, :48].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.wkv6_bthd(x, x.cpu(), x, w, u, s0)
    with pytest.raises(ValueError, match="like r"):
        wkv_kernel.wkv6_bthd(x, x.float(), x, w, u, s0)
    with pytest.raises(ValueError, match="unit stride"):
        wkv_kernel.wkv6_bthd(x.transpose(1, 3).contiguous().transpose(1, 3),
                             x, x, w, u, s0)
    with pytest.raises(ValueError, match="contiguous float32"):
        wkv_kernel.wkv6_bthd(x, x, x, w, u, s0.double())
    a = torch.zeros((1, 4, 32), device=cuda)
    B = torch.zeros((1, 4, 16), device=cuda)
    h0 = torch.zeros((1, 32, 16), device=cuda)
    with pytest.raises(ValueError, match="state size"):
        wide = torch.zeros((1, 4, 33), device=cuda)
        ssm_kernel.ssm_scan_btd(a, a, wide, wide,
                                torch.zeros((1, 32, 33), device=cuda))
    with pytest.raises(ValueError, match="like a"):
        ssm_kernel.ssm_scan_btd(a, a.bfloat16(), B, B, h0)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel.ssm_scan_btd(a, a, B.cpu(), B, h0)
    with pytest.raises(ValueError, match="h0 must be"):
        ssm_kernel.ssm_scan_btd(a, a, B, B, h0[:, :16])
