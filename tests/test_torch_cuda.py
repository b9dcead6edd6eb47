"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs.  Every test here needs a CUDA device and
skips without one; the file imports no JAX, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the Z_2^32 share-sums (fused and legacy) are exact; the float
MPC round equal bit for bit to its kernel-order model
(``ref.masked_rolling_update_kernel_order``) and within atol = P * 1e-6
of the plain version (both round the exact net pad once; they sum the
survivors' shares in another order); the
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


def _at_offset(t, k):
    """A contiguous copy of `t` that starts k elements into its storage."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


def _same_bits(a, b):
    """Bit-for-bit equality, NaN payloads included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _check_secure_agg(u, m, P):
    """Both fused kernels on (u, m): the share-sum equal to the plain
    version and the kernel-order model; the float round equal bit for bit
    to the kernel-order model, within atol = P * 1e-6 of the plain
    version, dead rows bit-untouched."""
    before = agg_kernel.masked_field_wsum_flat.launches
    words = agg_kernel.masked_field_wsum_flat(u, 99, m)
    assert agg_kernel.masked_field_wsum_flat.launches == before + 1
    assert words.dtype == torch.int32
    assert torch.equal(words, agg_ref.masked_field_wsum_reference(u, 99, m))
    assert torch.equal(words,
                       agg_ref.masked_field_wsum_kernel_order(u, 99, m))
    before = agg_kernel.masked_rolling_update_flat.launches
    out = agg_kernel.masked_rolling_update_flat(u, 99, 0.7, m)
    assert agg_kernel.masked_rolling_update_flat.launches == before + 1
    assert _same_bits(
        out, agg_ref.masked_rolling_update_kernel_order(u, 99, 0.7, m))
    want = agg_ref.masked_rolling_update_reference(u, 99, 0.7, m)
    torch.testing.assert_close(out, want, atol=P * 1e-6, rtol=0,
                               equal_nan=True)
    if m is not None:
        dead = m == 0
        assert _same_bits(out[dead], u[dead])


def _check_dp(u, m):
    """The DP kernel on (u, m): within rtol = 1e-5, atol = 1e-6 of the
    plain version, equal bit for bit to its kernel-order model
    (``dp_ref.clip_noise_kernel_order``), dead rows bit-untouched."""
    norms = dp_ref._row_norms(u)
    before = dp_kernel.clip_noise_flat.launches
    out = dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
    assert dp_kernel.clip_noise_flat.launches == before + 1
    want = dp_ref.clip_noise_reference(u, 5, 0.5, 1.0, m, norms)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    model = dp_ref.clip_noise_kernel_order(u, 5, 0.5, 1.0, m, norms)
    differ = int((out.view(torch.int32) != model.view(torch.int32)).sum())
    assert differ == 0, f"{differ} of {out.numel()} differ from the model"
    if m is not None:
        dead = m == 0
        assert _same_bits(out[dead], u[dead])


# N = 2, 3, 5; 129, one column past a block's 128; N % 4 == 0 and != 0
@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 5, 129, 4096, 4097, 109634])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", [1, 2, 10, 16])
def test_secure_agg_kernels_match_plain(cuda, P, N, mask_kind):
    u, m = _case(P, N, mask_kind, cuda)
    _check_secure_agg(u, m, P)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_secure_agg_kernels_take_offset_views(cuda, k, mask_kind):
    """N % 4 == 0, but the rows start off a 16-byte boundary."""
    u, m = _case(10, 4096, mask_kind, cuda)
    _check_secure_agg(_at_offset(u, k), m, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
def test_secure_agg_kernels_are_repeatable(cuda, mask_kind):
    """21 calls at the main path's (10, 109,634) give the same bits, the
    DP kernel's too."""
    u, m = _case(10, 109634, mask_kind, cuda)
    norms = dp_ref._row_norms(u)
    out = agg_kernel.masked_rolling_update_flat(u, 5, 0.7, m)
    words = agg_kernel.masked_field_wsum_flat(u, 5, m)
    noised = dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
    for _ in range(20):
        assert _same_bits(agg_kernel.masked_rolling_update_flat(u, 5, 0.7, m),
                          out)
        assert torch.equal(agg_kernel.masked_field_wsum_flat(u, 5, m), words)
        assert _same_bits(dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m),
                          noised)


@pytest.mark.cuda
def test_secure_agg_kernels_match_plain_many_waves(cuda):
    """(10, 2^24 + 3): 131,073 blocks, so many waves; two dead rows; the
    DP kernel too."""
    u, m = _case(10, 2 ** 24 + 3, "two_dead", cuda)
    words = agg_kernel.masked_field_wsum_flat(u, 3, m)
    assert torch.equal(words, agg_ref.masked_field_wsum_reference(u, 3, m))
    out = agg_kernel.masked_rolling_update_flat(u, 3, 0.7, m)
    torch.testing.assert_close(
        out, agg_ref.masked_rolling_update_reference(u, 3, 0.7, m),
        atol=10 * 1e-6, rtol=0, equal_nan=True)
    _check_dp(u, m)


# P = 1 and 16, the edges of the kernel's template; N = 129, one column
# past a block's 128; the main path's (10, 109,634)
@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 129, 4097, 109634])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", [1, 10, 16])
def test_dp_kernel_matches_plain(cuda, P, N, mask_kind):
    u, m = _case(P, N, mask_kind, cuda)
    _check_dp(u, m)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dp_kernel_takes_offset_views(cuda, k, mask_kind):
    """The rows start k elements into their storage."""
    u, m = _case(10, 4097, mask_kind, cuda)
    _check_dp(_at_offset(u, k), m)


# ----------------------------------------------------------------------
# the fused kernels past 16 rows: the same entry points launch their
# P > 16 kernels (counted on `launches_wide`), held to the same standards
# and equal bit for bit to the kernel-order models (the pair models on the
# first columns only: they hold every pair's int64 words at once)

_WIDE_WORDS = 2 ** 27


def _wide_case(P, N, dead, offset, device):
    rng = np.random.default_rng([P, N, len(dead), offset])
    u = rng.standard_normal((P, N)).astype(np.float32)
    mask = None
    if dead:
        mask = np.ones(P, np.float32)
        mask[list(dead)] = 0.0
        u[dead[0]] = np.inf
        u[dead[1]] = np.nan
        mask = torch.from_numpy(mask).to(device)
    return _at_offset(torch.from_numpy(u).to(device), offset), mask


def _dead_tile(P):
    """One whole 16-row tile of the pair walk: the middle one, or tile 0
    where the middle one is the ragged last."""
    T = -(-P // 16)
    t = T // 2 if 16 * (T // 2 + 1) <= P else 0
    return tuple(range(16 * t, 16 * t + 16))


# P = 17, 32, 64, 128 at N = 3, a ragged N and the CNN's; each side of a
# tile's edge with all rows alive, rows 0 and 4 dead or a tile dead; a dead
# tile at each P; P = 433, whose accumulators pass shared memory (a global
# workspace, 64-bit float nets); rows one element into their storage
_WIDE_CASES = (
    [(P, N, dead, 0) for P in (17, 32, 64, 128) for N in (3, 4097, 109634)
     for dead in ((), (0, 4))]
    + [(P, N, dead, 0) for P in (31, 33, 47, 48, 49) for N in (3, 4097)
       for dead in ((), (0, 4), _dead_tile(P))]
    + [(P, 4097, _dead_tile(P), 0) for P in (17, 32, 64, 128)]
    + [(33, 4097, (0, 4), 1), (433, 3, (0, 4), 0),
       (433, 129, _dead_tile(433), 0)])


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,dead,offset", _WIDE_CASES)
def test_fused_kernels_past_16_rows_match_plain(cuda, P, N, dead, offset):
    u, m = _wide_case(P, N, dead, offset, cuda)
    cols = min(N, _WIDE_WORDS // (P * (P - 1) // 2))
    chunk = max(1024, _WIDE_WORDS // (P * (P - 1) // 2))
    head = u if cols == N else u[:, :cols].contiguous()

    before = agg_kernel.masked_field_wsum_flat.launches_wide
    words = agg_kernel.masked_field_wsum_flat(u, 99, m)
    assert agg_kernel.masked_field_wsum_flat.launches_wide == before + 1
    assert torch.equal(words, agg_ref.masked_field_wsum_reference(
        u, 99, m, chunk=chunk))
    assert torch.equal(words[:cols],
                       agg_ref.masked_field_wsum_kernel_order(head, 99, m))

    before = agg_kernel.masked_rolling_update_flat.launches_wide
    out = agg_kernel.masked_rolling_update_flat(u, 99, 0.7, m)
    assert agg_kernel.masked_rolling_update_flat.launches_wide == before + 1
    torch.testing.assert_close(
        out, agg_ref.masked_rolling_update_reference(u, 99, 0.7, m,
                                                     chunk=chunk),
        atol=P * 1e-6, rtol=0, equal_nan=True)
    assert _same_bits(out[:, :cols],
                      agg_ref.masked_rolling_update_kernel_order(
                          head, 99, 0.7, m))

    norms = dp_ref._row_norms(u)
    before = dp_kernel.clip_noise_flat.launches_wide
    noised = dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
    assert dp_kernel.clip_noise_flat.launches_wide == before + 1
    torch.testing.assert_close(
        noised, dp_ref.clip_noise_reference(u, 5, 0.5, 1.0, m, norms),
        rtol=1e-5, atol=1e-6, equal_nan=True)
    assert _same_bits(noised, dp_ref.clip_noise_kernel_order(
        u, 5, 0.5, 1.0, m, norms))
    for p in dead:
        assert _same_bits(out[p], u[p]) and _same_bits(noised[p], u[p])


# the DP kernel past 16 rows takes a column's rows 16 at a time and
# stages the constants of 256 rows at once: P short of a whole group (40),
# one row past a stage (257) and a ragged second stage (300), at N = 3 and
# a ragged N, all alive, rows 0 and 4 dead, or rows 4 and P - 1 (the last
# group's, the second stage's) dead
_DP_WIDE_CASES = [(P, N, dead) for P in (40, 257, 300) for N in (3, 4097)
                  for dead in ((), (0, 4), (4, P - 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,dead", _DP_WIDE_CASES)
def test_dp_kernel_past_16_rows_groups_and_stages(cuda, P, N, dead):
    """Equal bit for bit to `clip_noise_kernel_order` and within rtol
    1e-5, atol 1e-6 of the plain version, dead rows bit-untouched."""
    u, m = _wide_case(P, N, dead, 0, cuda)
    norms = dp_ref._row_norms(u)
    before = dp_kernel.clip_noise_flat.launches_wide
    noised = dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
    assert dp_kernel.clip_noise_flat.launches_wide == before + 1
    torch.testing.assert_close(
        noised, dp_ref.clip_noise_reference(u, 5, 0.5, 1.0, m, norms),
        rtol=1e-5, atol=1e-6, equal_nan=True)
    assert _same_bits(noised, dp_ref.clip_noise_kernel_order(
        u, 5, 0.5, 1.0, m, norms))
    for p in dead:
        assert _same_bits(noised[p], u[p])


@pytest.mark.cuda
def test_dp_kernel_past_16_rows_is_one_launch(cuda):
    """A call past 16 rows launches one kernel and nothing else: its
    stream keys come from the kernel itself, not a key kernel and a
    workspace."""
    u, m = _wide_case(32, 4097, (0, 4), 0, cuda)
    norms = dp_ref._row_norms(u)
    dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
    torch.cuda.synchronize()
    calls = 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            dp_kernel.clip_noise_flat(u, norms, 5, 0.5, 1.0, m)
        torch.cuda.synchronize()
    # a trace may miss a few launches at the start of its window, never
    # record one that did not happen
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    assert 0 < len(names) <= calls, names
    assert all("clip_noise_wide_kernel" in n for n in names), set(names)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    u = torch.zeros((3, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        agg_kernel.masked_rolling_update_flat(u.double(), 1, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        agg_kernel.masked_field_wsum_flat(u.t().contiguous().t(), 1)
    # P = 0 rows, or rows that are not (P, N): any P >= 1 runs
    for bad in (torch.zeros((0, 8), device=cuda),
                torch.zeros((8,), device=cuda)):
        with pytest.raises(ValueError, match=r"\(P, N\) with 1 <= P"):
            dp_kernel.clip_noise_flat(bad, torch.ones((1, 1), device=cuda),
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_same_seed_runs_bit_equal_and_crash_resumes(cuda, mode, tmp_path):
    """Two same-seed P = 5 federations end bit-equal on the card (the
    local step's cuDNN convolutions are held deterministic), and a run
    killed at round 3 resumes from its round-2 snapshot bit-identical."""
    from repro_torch.chaos import (
        CoordinatorCrash, Dropout, compose, golden_run, simulate_crash_run,
    )
    sched = compose(Dropout(rate=0.3, seed=5),
                    CoordinatorCrash(rounds=(3,), fatal=True))

    def mk():
        return CNNFederation(
            sched, 0, n_institutions=5, image_size=16, width_scale=0.25,
            device=cuda, secure_domain="int" if mode == "int" else "float",
            dp=DPConfig(0.5, 1.0) if mode == "dp" else None)
    golden = golden_run(mk, 6)
    assert golden_run(mk, 6) == golden
    rep = simulate_crash_run(mk, 6, 3, str(tmp_path), snapshot_every=2)
    assert rep.restored_round == 2 and rep.rounds_replayed == 1
    assert (rep.chain_digest, rep.params_fingerprint) == golden


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
    from each device's log1p, and the pads cancel to fp32 rounding)."""
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
# window, layout); layout "" gives q, k, v tensors of their own, "qkv"
# slices them from one fused projection, "odd" starts q one element into
# its storage (not 16-byte aligned: the bf16 kernel's plain-load path)
FLASH_CASES = [
    (1, 1000, 16, 8, 128, torch.bfloat16, True, 0, ""),   # qwen3, ragged S
    (2, 192, 6, 3, 32, torch.bfloat16, True, 0, ""),
    (2, 192, 6, 3, 32, torch.float32, True, 0, ""),
    (1, 512, 4, 1, 80, torch.bfloat16, True, 0, ""),
    (2, 256, 15, 5, 64, torch.bfloat16, True, 0, ""),
    (2, 256, 4, 2, 64, torch.float32, True, 16, ""),
    (2, 256, 4, 2, 64, torch.float32, True, 64, ""),
    (2, 256, 4, 2, 64, torch.float32, True, 100, ""),
    (1, 200, 4, 2, 64, torch.float32, False, 0, ""),      # non-causal ragged
    (1, 1152, 25, 5, 64, torch.bfloat16, True, 1024, ""),  # hymba's prefill
    # the bf16 kernel's tile edges (64 q rows a warpgroup, 64 kv rows a
    # tile): S on each side of one and two tiles, a window ending inside
    # a kv tile, GQA group 5, hd 80 ragged, non-causal, fused and
    # unaligned layouts
    (1, 1, 4, 2, 64, torch.bfloat16, True, 0, ""),
    (1, 63, 4, 2, 128, torch.bfloat16, True, 0, ""),
    (1, 65, 4, 2, 128, torch.bfloat16, True, 0, ""),
    (1, 127, 4, 2, 32, torch.bfloat16, True, 0, ""),
    (1, 129, 4, 2, 80, torch.bfloat16, True, 0, ""),
    (1, 300, 4, 2, 64, torch.bfloat16, True, 100, ""),
    (1, 130, 10, 2, 64, torch.bfloat16, True, 0, ""),     # group 5
    (1, 200, 4, 2, 64, torch.bfloat16, False, 0, ""),
    (2, 190, 8, 2, 128, torch.bfloat16, True, 0, "qkv"),
    (2, 190, 8, 2, 64, torch.bfloat16, True, 0, "odd"),
    # the fp32 kernel's tile edges (64 q rows a half-block, two q tiles a
    # block, 64 kv rows a tile): S on each side of one and two tiles and
    # of a pair, one q row, hd 80 and 32, non-causal, a window ending
    # inside a kv tile, hymba's prefill (GQA group 5, window 1024), fused
    # and unaligned layouts (the unaligned one takes 4-byte copies)
    (1, 1, 4, 2, 64, torch.float32, True, 0, ""),
    (1, 63, 4, 2, 128, torch.float32, True, 0, ""),
    (1, 65, 4, 2, 128, torch.float32, True, 0, ""),
    (1, 127, 4, 2, 32, torch.float32, True, 0, ""),
    (1, 129, 4, 2, 80, torch.float32, True, 0, ""),
    (1, 191, 4, 2, 80, torch.float32, False, 0, ""),
    (2, 193, 6, 3, 128, torch.float32, True, 100, ""),
    (1, 1152, 25, 5, 64, torch.float32, True, 1024, ""),
    (2, 190, 8, 2, 128, torch.float32, True, 0, "qkv"),
    (2, 190, 8, 2, 64, torch.float32, True, 0, "odd"),
    # the families' prefill at full width: hubert-xlarge's encoder over 4
    # clips of 1,500 frames (non-causal, hd 80), llava-next's 2,304
    # patches and 2,048 tokens under its 4,096-token window, olmoe's
    # served prompts (group 1, up to 1,024 tokens) and dbrx's 2 prompts
    # of 1,024 tokens (group 6)
    (4, 1500, 16, 16, 80, torch.bfloat16, False, 0, ""),
    (1, 4352, 32, 8, 128, torch.bfloat16, True, 4096, ""),
    (1, 1000, 16, 16, 128, torch.bfloat16, True, 0, ""),
    (2, 1024, 48, 8, 128, torch.bfloat16, True, 0, ""),
]


def _flash_inputs(B, S, Hq, Hkv, hd, dtype, device, layout="", seed=0):
    rng = np.random.default_rng([seed, B, S, Hq, Hkv, hd])
    if layout == "qkv":
        qkv = torch.from_numpy(rng.standard_normal(
            (B, S, Hq + 2 * Hkv, hd)).astype(np.float32)).to(device=device,
                                                              dtype=dtype)
        return list(qkv.split([Hq, Hkv, Hkv], dim=2))
    q, k, v = [torch.from_numpy(rng.standard_normal(
        (B, S, h, hd)).astype(np.float32)).to(device=device, dtype=dtype)
        for h in (Hq, Hkv, Hkv)]
    if layout == "odd":
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
        assert q.data_ptr() % 16
    return [q, k, v]


def _flash_plain(q, k, v, causal, window):
    return fa_ref.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, case):
    B, S, Hq, Hkv, hd, dtype, causal, window, layout = case
    q, k, v = _flash_inputs(B, S, Hq, Hkv, hd, dtype, cuda, layout)
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
@pytest.mark.parametrize("Sq,Skv,hd,causal,window",
                         [(130, 70, 64, True, 8), (200, 65, 128, True, 16),
                          (130, 40, 80, False, 8)])
def test_flash_kernel_f32_rows_without_keys(cuda, Sq, Skv, hd, causal,
                                            window):
    """fp32, Sq > Skv under a window, across the kernel's tile edges: a q
    row q >= Skv + window - 1 has no key to attend to and is 0; the rest
    match the plain version."""
    rng = np.random.default_rng([Sq, Skv, hd])
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, h, s, hd)).astype(np.float32)).to(cuda)
        for h, s in ((4, Sq), (2, Skv), (2, Skv)))
    out = fa_kernel.flash_attention_bhsd(q, k, v, causal=causal,
                                         window=window)
    want = fa_ref.attention_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    assert bool((out[:, :, Skv + window - 1:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=str)
def test_flash_kernel_without_keys_returns_zeros(cuda, dtype):
    """Skv = 0: no q row has a key, so every row is 0 (the bf16 kernel
    takes its plain loads: a tensor map has no zero dimension)."""
    q = torch.ones((2, 4, 70, 128), device=cuda, dtype=dtype)
    kv = torch.ones((2, 2, 0, 128), device=cuda, dtype=dtype)
    for causal in (True, False):
        out = fa_kernel.flash_attention_bhsd(q, kv, kv, causal=causal)
        torch.cuda.synchronize()
        assert out.shape == q.shape and bool((out == 0).all())


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
def test_smem_allowance_is_set_once_per_device(cuda):
    """After a first call, flash (bf16 and fp32) and WKV6 (prefill and
    decode) launch without another cudaFuncSetAttribute."""
    rng = np.random.default_rng(7)

    def calls():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(1, 130, 4, 2, 64, dtype, cuda)
            fa_ops.flash_attention(q, k, v, causal=True)
        for T in (1, 40):
            r, k, v = (_randn(rng, 1, T, 2, 64).to(cuda, torch.bfloat16)
                       for _ in range(3))
            w = torch.rand((1, T, 2, 64), device=cuda)
            wkv_kernel.wkv6_bthd(r, k, v, w, torch.zeros((2, 64), device=cuda),
                                 torch.zeros((1, 2, 64, 64), device=cuda))
        torch.cuda.synchronize()

    calls()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        calls()
    names = [e.name for e in prof.events()]
    assert any("LaunchKernel" in n for n in names), sorted(set(names))
    assert not any("cudaFuncSetAttribute" in n for n in names)


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
# strided) and the selective scan (Bz, T, di, N, dtype, nonzero h0,
# inputs), the smoke's shapes; bf16 y within atol = rtol = 2e-2 (the flash kernel's
# bound), fp32 y and the fp32 states within 1e-4 of the largest magnitude
# (the kernels sum in another order than the plain versions)
WKV6_CASES = [
    (1, 1000, 40, 64, torch.bfloat16, torch.float32, False, False),
    (8, 1, 40, 64, torch.bfloat16, torch.float32, True, False),
    (2, 77, 4, 32, torch.float32, torch.float32, True, False),
    (2, 40, 3, 16, torch.bfloat16, torch.bfloat16, True, False),
    (1, 33, 2, 128, torch.float32, torch.float32, True, False),
    (2, 50, 4, 64, torch.bfloat16, torch.float32, True, True),
    # the split kernel's edges: 16-column groups and 8-row lanes at hd 16
    # / 32 / 128, T = 1 at other hd, T not a multiple of the 16-token chunk
    (2, 13, 3, 128, torch.bfloat16, torch.float32, True, False),
    (1, 21, 5, 32, torch.bfloat16, torch.bfloat16, True, True),
    (3, 1, 2, 16, torch.float32, torch.float32, True, False),
    (8, 1, 4, 128, torch.bfloat16, torch.float32, True, False),
    (1, 1001, 40, 64, torch.bfloat16, torch.float32, True, False),
]
# the selective scan's inputs: "" contiguous, "strided" a every other
# token and bx the first di columns of wider rows (aligned: TMA through
# strides), "odd" a and bx one element into their storage (element
# copies), "a1" a = 1, "a0" a in (1e-4, 1e-2) (chunk decays underflow)
SSM_CASES = [
    (1, 1152, 3200, 16, torch.float32, False, ""),
    (8, 1, 3200, 16, torch.float32, True, ""),
    (2, 100, 1001, 16, torch.float32, True, ""),
    (2, 70, 515, 8, torch.bfloat16, True, ""),
    (1, 37, 96, 5, torch.float32, True, ""),
    # the redesign's edges: T on each side of 4 boxes of 16 tokens, T = 2
    # and each side of the decode kernel's T <= 8, Bz = 3 at hymba's
    # prefill, N = 1 and 32, strided and unaligned views, a = 1 and ~0
    (2, 63, 384, 16, torch.float32, True, ""),
    (2, 64, 384, 16, torch.bfloat16, True, ""),
    (2, 65, 384, 16, torch.float32, True, ""),
    (3, 2, 640, 16, torch.float32, True, ""),
    (2, 7, 300, 16, torch.float32, True, ""),
    (2, 8, 300, 5, torch.bfloat16, True, ""),
    (2, 9, 300, 16, torch.float32, True, ""),
    (3, 1152, 3200, 16, torch.float32, True, ""),
    (2, 200, 256, 1, torch.float32, True, ""),
    (2, 200, 256, 32, torch.float32, True, ""),
    (2, 130, 256, 32, torch.bfloat16, True, ""),
    (2, 150, 512, 16, torch.float32, True, "strided"),
    (2, 150, 512, 16, torch.bfloat16, True, "odd"),
    (1, 1152, 256, 16, torch.float32, True, "a1"),
    (1, 1152, 256, 16, torch.float32, True, "a0"),
    # N a multiple of 4 below its padded NP (the decode kernel's quads
    # past a row's end hold none), at T = 1 and in a sequence
    (8, 1, 3200, 12, torch.float32, True, ""),
    (4, 1, 515, 24, torch.float32, True, ""),
    (2, 5, 300, 20, torch.bfloat16, True, ""),
    (2, 1, 256, 28, torch.float32, True, ""),
    (2, 100, 300, 12, torch.float32, True, ""),
    # T on each side of the 128-token chunk
    (2, 127, 384, 16, torch.float32, True, ""),
    (2, 128, 384, 16, torch.bfloat16, True, ""),
    (2, 129, 384, 16, torch.float32, True, ""),
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


def _ssm_view(x, kind, which):
    Bz, T, di = x.shape
    if kind == "strided":
        big = torch.zeros((Bz, 2 * T, di) if which == "a" else
                          (Bz, T, di + 8), dtype=x.dtype, device=x.device)
        view = big[:, ::2] if which == "a" else big[..., :di]
        view.copy_(x)
        return view
    if kind == "odd":
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        flat[1:] = x.flatten()
        return flat[1:].view(x.shape)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_ssm_scan_kernel_matches_plain(cuda, case):
    Bz, T, di, N, dtype, h0_nz, kind = case
    rng = np.random.default_rng([Bz, T, di, N] + ([len(kind)] if kind
                                                   else []))
    a = torch.sigmoid(_randn(rng, Bz, T, di) + 2)
    if kind == "a1":
        a = torch.ones_like(a)
    elif kind == "a0":
        a = torch.from_numpy(rng.uniform(1e-4, 1e-2, (Bz, T, di)).astype(
            np.float32))
    a = _ssm_view(a.to(cuda, dtype), kind, "a")
    bx = _ssm_view(_randn(rng, Bz, T, di).to(cuda, dtype), kind, "bx")
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
@pytest.mark.parametrize("Bz", [1, 3])
def test_ssm_scan_kernel_is_repeatable(cuda, Bz):
    """At hymba's prefill shape every call gives the same bits: the
    chunks compose their carries in a fixed order, whichever block runs
    first."""
    T, di, N = 1152, 3200, 16
    rng = np.random.default_rng([Bz, T, di, N, 7])
    a = torch.sigmoid(_randn(rng, Bz, T, di) + 2).to(cuda)
    bx = _randn(rng, Bz, T, di).to(cuda)
    Bm, Cm = (_randn(rng, Bz, T, N).to(cuda) for _ in range(2))
    h0 = _randn(rng, Bz, di, N).to(cuda)
    y0, h0_last = ssm_kernel.ssm_scan_btd(a, bx, Bm, Cm, h0)
    for _ in range(10):
        y, h = ssm_kernel.ssm_scan_btd(a, bx, Bm, Cm, h0)
        assert torch.equal(y, y0) and torch.equal(h, h0_last)


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


# ----------------------------------------------------------------------
# the device tier: plain PyTorch on the card, held against the CPU

def _device_tier_fns(P=4):
    from repro_torch.chaos import DeviceSchedule
    from repro_torch.data import (
        DeviceShardSpec, DirichletPartitioner, institution_class_mixes,
        make_centroid_pull_update, make_device_data_fn,
    )
    spec = DeviceShardSpec(n_classes=4, n_features=6, min_samples=1,
                           max_samples=9, seed=3)
    mixes = institution_class_mixes(
        DirichletPartitioner(alpha=0.5, n_institutions=P, seed=1), 4)
    sched = DeviceSchedule(dropout_rate=0.25, straggler_rate=0.3,
                           max_delay_s=2.0, deadline_s=1.0, seed=5)
    return (make_device_data_fn(spec, mixes),
            make_centroid_pull_update(spec), sched)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_device_sweep_on_card_bitequal_to_cpu(cuda, chunk):
    """Three chained sweeps (faults, staleness 1): the card's limbs, stats
    and decoded means equal the CPU's bit for bit."""
    from repro_torch.core.device_tier import (
        DeviceTierConfig, device_sweep, zero_stale,
    )
    data_fn, update_fn, sched = _device_tier_fns()
    cfg = DeviceTierConfig(n_devices=60, chunk_size=chunk, max_weight=16,
                           faults=sched)
    outs = {}
    for dev in ("cpu", cuda):
        p = {"w": torch.linspace(-1.0, 1.0, 6, device=dev)}
        stale, chain = zero_stale(p), []
        for s in range(3):
            upd, stale, stats = device_sweep(
                p, torch.tensor(s, dtype=torch.int32, device=dev),
                torch.tensor(2, dtype=torch.int32, device=dev), stale, cfg,
                data_fn, update_fn)
            p = {"w": p["w"] + upd["w"]}
            chain.append([x.cpu() for x in
                          tree_flatten((upd, stale, stats))[0]])
        outs[str(dev)] = chain
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            assert torch.equal(x.to(torch.float64), y.to(torch.float64))


@pytest.mark.cuda
def test_device_schedule_draw_on_card_equals_draw_host(cuda):
    data_fn, _, sched = _device_tier_fns()
    ids = np.arange(5000, dtype=np.int32)
    for sweep, inst in [(0, 0), (3, 1), (17, 63)]:
        on, late = sched.draw(torch.tensor(sweep, device=cuda), inst,
                              torch.from_numpy(ids).to(cuda))
        on_h, late_h = sched.draw_host(sweep, inst, ids.astype(np.uint32))
        assert on.is_cuda
        np.testing.assert_array_equal(on.cpu().numpy(), on_h)
        np.testing.assert_array_equal(late.cpu().numpy(), late_h)


@pytest.mark.cuda
def test_hierarchical_device_merge_on_card_matches_cpu(cuda):
    from repro_torch.core.merges import hierarchical_device_merge
    g = np.random.default_rng(2)
    x = g.standard_normal((8, 37, 5)).astype(np.float32)
    w = g.integers(0, 5000, 8).astype(np.uint32)
    mask = np.array([True, True, False, True, True, True, False, True])
    for m in (None, mask):
        outs = []
        for dev in ("cpu", cuda):
            outs.append(hierarchical_device_merge(
                {"w": torch.from_numpy(x).to(dev)}, True,
                weights=torch.from_numpy(w).to(dev),
                mask=None if m is None else torch.from_numpy(m).to(dev)))
        np.testing.assert_allclose(outs[1]["w"].cpu().numpy(),
                                   outs[0]["w"].numpy(), atol=1e-6, rtol=0)
        if m is not None:
            assert torch.equal(outs[1]["w"][2].cpu(), torch.from_numpy(x[2]))


# ----------------------------------------------------------------------
# training: the LM kernels refuse gradients; the trainer's plain paths

def _lm_kernel_calls(cuda):
    """(name, inputs, call) of each forward-only LM kernel at a small
    shape; `call` returns a tensor output."""
    g = torch.Generator(cuda).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    q, kv = randn(1, 2, 64, 64), randn(1, 1, 64, 64)
    r = randn(1, 16, 2, 64)
    w = -torch.rand((1, 16, 2, 64), generator=g, device=cuda)
    u, s0 = randn(2, 64, dtype=torch.float32), torch.zeros((1, 2, 64, 64),
                                                           device=cuda)
    a = torch.rand((1, 40, 32), generator=g, device=cuda)
    B, h0 = randn(1, 40, 16, dtype=torch.float32), torch.zeros(
        (1, 32, 16), device=cuda)
    return [
        ("flash_attention_bhsd", [q, kv, kv],
         lambda q, k, v: fa_kernel.flash_attention_bhsd(q, k, v)),
        ("wkv6_bthd", [r, r, r, w, u, s0],
         lambda *x: wkv_kernel.wkv6_bthd(*x)[0]),
        ("ssm_scan_btd", [a, a, B, B, h0],
         lambda *x: ssm_kernel.ssm_scan_btd(*x)[0]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
def test_lm_kernels_refuse_gradients(cuda, which):
    """A gradient through flash, WKV6 or the scan raises, under
    .backward() and under torch.func.grad, naming the plain path; without
    grad the same call launches (one more count)."""
    name, inputs, call = _lm_kernel_calls(cuda)[which]
    wrapper = {"flash_attention_bhsd": fa_kernel.flash_attention_bhsd,
               "wkv6_bthd": wkv_kernel.wkv6_bthd,
               "ssm_scan_btd": ssm_kernel.ssm_scan_btd}[name]
    before = wrapper.launches
    tracked = [inputs[0].clone().requires_grad_()] + inputs[1:]
    with pytest.raises(RuntimeError, match=f'{name}.*no backward.*impl="ref"'):
        call(*tracked).float().sum().backward()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        torch.func.grad(lambda x: call(x, *inputs[1:]).float().sum())(
            inputs[0])
    with pytest.raises(RuntimeError, match="no backward kernel"):
        torch.func.vmap(torch.func.grad(
            lambda x: call(x[None], *inputs[1:]).float().sum()))(inputs[0])
    assert wrapper.launches == before
    with torch.no_grad():
        call(*tracked)
    call(*inputs)
    assert wrapper.launches == before + 2


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """Two steps of reduced smollm-360m (the trainer's impl="auto": the
    plain paths on the card too) equal the CPU's: loss within rtol 1e-3,
    AdamW's m and v within 4% of each leaf's largest (bf16 compute; the
    CPU's bf16 moments read 1.4-1.7% against the JAX package's), no
    kernel launched.  The first step's lr is 0 (warm-up), so m holds
    both steps' gradients at the starting params; the params are not
    held, as AdamW moves one by about lr a step whatever its gradient."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_map
    from repro_torch.training import TrainConfig, make_train_step
    cfg = reduced(ARCHS["smollm-360m"])
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 4, 48)).astype(np.int32)
    host = models.init_params(cfg, torch.Generator().manual_seed(0))
    before = fa_kernel.flash_attention_bhsd.launches
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev), host)
        step = make_train_step(cfg, TrainConfig(
            optimizer=AdamWConfig(learning_rate=1e-3), warmup_steps=1,
            total_steps=4))
        opt = adamw_init(params)
        for s in range(2):
            params, opt, m = step(params, opt,
                                  torch.tensor(s, dtype=torch.int32,
                                               device=dev),
                                  {"tokens": torch.from_numpy(toks[s])
                                   .to(dev)})
        out[str(dev)] = (float(m["loss"]), tree_map(lambda x: x.cpu(), opt))
    assert fa_kernel.flash_attention_bhsd.launches == before
    np.testing.assert_allclose(out[str(cuda)][0], out["cpu"][0], rtol=1e-3)
    for key in ("m", "v"):
        for a, b in zip(tree_flatten(out[str(cuda)][1][key])[0],
                        tree_flatten(out["cpu"][1][key])[0]):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=0.04 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b", "hymba-1.5b"])
def test_remat_under_vmap_grad_on_card(cuda, arch):
    """The recompute helper under vmap(grad) on the card, as the overlay
    calls the local step: gradients equal to no remat's bit for bit."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.pytree import tree_map
    from repro_torch.training import TrainConfig, make_loss_fn
    cfg = reduced(ARCHS[arch])
    params = models.init_params(cfg, torch.Generator(cuda).manual_seed(1))
    stacked = tree_map(lambda x: torch.stack([x, x * 0.9]), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 2, 40)).astype(np.int32)).to(cuda)
    grads = {}
    for remat in (False, True):
        fn = make_loss_fn(cfg, TrainConfig(remat=remat))
        grads[remat] = torch.func.vmap(torch.func.grad(fn, has_aux=True))(
            stacked, {"tokens": toks})[0]
    for a, b in zip(tree_flatten(grads[False])[0],
                    tree_flatten(grads[True])[0]):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the MoE, audio and VLM families, reduced: the card against the CPU

def _family_run(cfg, params, batch, dev):
    """Prefill (cache 128) and 2 decode steps, or an encoder's forward:
    the logits, on `dev`."""
    from repro_torch import models
    from repro_torch.pytree import tree_map
    p = tree_map(lambda x: x.to(dev), params)
    b = {k: v.to(dev) for k, v in batch.items()}
    if cfg.encoder_only:
        return [models.forward(cfg, p, b)[0].float().cpu()]
    lg, st, _ = models.prefill(cfg, p, b, 128)
    out = [lg.float().cpu()]
    S = lg.shape[1]
    for t in range(2):
        pos = torch.full((2,), S + t, dtype=torch.int32, device=dev)
        d, st = models.decode_step(cfg, p, st, torch.full(
            (2,), 5 + t, dtype=torch.int32, device=dev), pos)
        out.append(d.float().cpu())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_moe_routing_on_card_matches_cpu(cuda, monkeypatch, compute):
    """Reduced olmoe, prefill and 2 decode steps: in fp32 compute every
    token chooses the same experts on the card as on the CPU and the
    logits agree within 1e-4 of the largest; in bf16 (cuBLAS and the
    flash kernel round in other places than the CPU) a token may choose
    another expert only as `compare.routing_flips` allows (until the
    first flip the router inputs agree within 8 bf16 ulps, and that
    call's flips are within 8 bf16 ulps of its largest router logit),
    and the logits agree within 8 bf16 ulps of the largest."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import layers
    from repro_torch.models.compare import (RouterTap, bf16_ulps,
                                            family_batch, routes,
                                            routing_flips)
    if compute == "fp32":
        monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced(ARCHS["olmoe-1b-7b"])
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    batch = family_batch(cfg, 2, 61, 0)
    out, taps = {}, {}
    for dev in ("cpu", cuda):
        with RouterTap() as tap:
            out[str(dev)] = _family_run(cfg, params, batch, dev)
        taps[str(dev)] = routes(tap.calls)
    assert len(taps["cpu"]) == 3 * cfg.n_layers   # a prefill, 2 decodes
    report = routing_flips(taps[str(cuda)], taps["cpu"])
    if compute == "fp32":
        assert not report.flips, report.flips
    for a, b in zip(out[str(cuda)], out["cpu"]):
        atol = (1e-4 * float(b.abs().max()) if compute == "fp32"
                else bf16_ulps(b, 8))
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b"])
def test_encoder_and_vlm_launches_on_card(cuda, arch):
    """Reduced hubert's encoder forward and llava's prefill (16 patches
    and 61 tokens, past the window of 64) launch the flash kernel once a
    layer and decode launches none; the logits agree with the CPU's
    within 8 bf16 ulps of the largest."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.compare import family_batch
    cfg = reduced(ARCHS[arch])
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    batch = family_batch(cfg, 2, 61, 0)
    want = _family_run(cfg, params, batch, "cpu")
    before = fa_kernel.flash_attention_bhsd.launches
    got = _family_run(cfg, params, batch, cuda)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_bhsd.launches == before + cfg.n_layers
    for a, b in zip(got, want):
        atol = 8 * 2.0 ** (np.floor(np.log2(float(b.abs().max()))) - 7)
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.cuda
def test_moe_vmap_grad_on_card_matches_cpu(cuda, monkeypatch):
    """`LMFederation`'s local step shape: the next-token loss of reduced
    olmoe under ``vmap(grad)`` over two institutions (the routing's
    gathers and scatters batched), in fp32 compute: the card's gradients
    within 1e-4 of each leaf's largest of the CPU's, none lost."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import layers
    from repro_torch.pytree import tree_map
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced(ARCHS["olmoe-1b-7b"])
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    stacked = tree_map(lambda x: torch.stack([x, x * 0.9]), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 4, 16)).astype(np.int32))

    def loss_fn(p, t):
        logits, aux = models.forward(cfg, p, {"tokens": t}, impl="ref")
        lse = torch.logsumexp(logits[:, :-1], dim=-1)
        gold = torch.gather(logits[:, :-1], -1,
                            t[:, 1:].long()[..., None])[..., 0]
        return (lse - gold).mean() + 0.01 * aux["load_balance"]
    grads = {}
    for dev in ("cpu", cuda):
        grads[str(dev)] = torch.func.vmap(torch.func.grad(loss_fn))(
            tree_map(lambda x: x.to(dev), stacked), toks.to(dev))
    for a, b in zip(tree_flatten(grads[str(cuda)])[0],
                    tree_flatten(grads["cpu"])[0]):
        assert bool(b.abs().max() > 0)
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


# ----------------------------------------------------------------------
# the gossip shim and the dry-run's count on the card

_SHIM_CALLS = ["mean", "ring", "hierarchical", "quantized", "secure_mean"]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", _SHIM_CALLS)
def test_gossip_shim_equals_the_registry_on_the_card(cuda, name, masked):
    from repro_torch import random as prng
    from repro_torch.core import gossip
    from repro_torch.core.merges import MergeContext, get_merge
    g = torch.Generator(cuda).manual_seed(3)
    tree = {"w": torch.randn(10, 4097, generator=g, device=cuda),
            "b": [torch.randn(10, 3, 5, generator=g, device=cuda)]}
    mask = None
    if masked:
        mask = torch.ones(10, dtype=torch.bool, device=cuda)
        mask[[0, 4]] = False
    key = prng.PRNGKey(5)
    kw = {"ring": dict(shift=2), "hierarchical": dict(group_size=5),
          "secure_mean": dict(key=key)}.get(name, {})
    shim = {"mean": gossip.mean_merge, "ring": gossip.ring_merge,
            "hierarchical": gossip.hierarchical_merge,
            "quantized": gossip.quantized_mean_merge,
            "secure_mean": gossip.secure_mean_merge}[name]
    got = shim(tree, True, alpha=0.7, mask=mask, **kw)
    want = get_merge(name).merge(tree, MergeContext(
        commit=True, mask=mask, alpha=0.7, **kw))
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b", "hymba-1.5b"])
def test_dryrun_count_equals_flop_counter_on_the_card(cuda, arch):
    """A reduced train step counted on meta tensors and run on the card
    under FlopCounterMode, impl="ref": equal matmul FLOPs and args."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import INPUT_SHAPES, get_config, reduced
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.optim import adamw_init
    from repro_torch.pytree import tree_map
    cfg = reduced(get_config(arch))
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
    fn, meta = dryrun.step_and_args(cfg, shape, "ref")
    counts = op_cost.analyze_ops(fn, *meta)
    g = torch.Generator(cuda).manual_seed(0)
    params = tree_map(lambda t: 0.02 * torch.randn(
        t.shape, generator=g, device=cuda), meta[0])
    batch = tree_map(lambda t: torch.randint(
        1, cfg.vocab_size, t.shape, generator=g, device=cuda,
        dtype=t.dtype), meta[3])
    args = (params, adamw_init(params),
            torch.zeros((), dtype=torch.int32, device=cuda), batch)
    assert dryrun._storage_bytes(args) == dryrun._storage_bytes(meta)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert counts["matmul_flops"] == fc.get_total_flops()
