"""The port's dry-run (`launch.dryrun`, `launch.analysis`,
`launch.op_cost`) and the metadata it reads, held against the JAX
package.

Exact: `model_flops` and `resolve_variant` for every (arch x shape); the
shapes, dtypes and logical axes of `abstract_params`, `param_axes`,
`decode_state_specs`, `optimizer_abstract_state` and
`optimizer_state_axes` at published widths (the reference's trees are
``ShapeDtypeStruct``s: no compute); the count's matmul FLOPs and the
reference's HLO ``dot`` FLOPs (its ``hlo_cost`` trip-count accounting)
for reduced forwards; a recurrence counted from short lengths and the
same recurrence dispatched in full.  The reference's
``launch/dryrun.py`` sets a 512-device XLA flag when imported, so its
`resolve_variant` is read out of the file instead.
"""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import reduced as jax_reduced
from repro.launch import analysis as jax_analysis
from repro.launch import hlo_cost
from repro.optim import adamw as jax_adamw
from repro_torch import models
from repro_torch.configs import ARCHS, INPUT_SHAPES, reduced
from repro_torch.continuum.resources import H100_SXM
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.launch import analysis, dryrun, op_cost
from repro_torch.models import layers as L
from repro_torch.optim import optimizer_abstract_state, optimizer_state_axes
from repro_torch.pytree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _reference_resolve_variant():
    path = os.path.join(SRC, "repro", "launch", "dryrun.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "resolve_variant")
            or (isinstance(n, ast.Assign) and any(
                getattr(t, "id", None) == "SWA_VARIANT_WINDOW"
                for t in n.targets))]
    from repro.configs.base import InputShape, ModelConfig
    ns = {"dataclasses": dataclasses, "InputShape": InputShape,
          "ModelConfig": ModelConfig}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns["resolve_variant"]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _port_specs(tree):
    return tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)


def _jax_specs(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


# ----------------------------------------------------------------------
# model_flops, resolve_variant and the metadata trees: exact

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_variants_equal_the_reference(arch):
    ref_resolve = _reference_resolve_variant()
    for name in INPUT_SHAPES:
        ours, theirs = INPUT_SHAPES[name], JAX_SHAPES[name]
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        cfg, variant = dryrun.resolve_variant(ARCHS[arch], ours)
        jcfg, jvariant = ref_resolve(JAX_ARCHS[arch], theirs)
        assert variant == jvariant
        assert (cfg is None) == (jcfg is None)
        if cfg is None:
            continue
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert analysis.model_flops(cfg, ours) == \
            jax_analysis.model_flops(jcfg, theirs)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_metadata_trees_equal_the_reference(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    params, jparams = models.abstract_params(cfg), \
        jax_models.abstract_params(jcfg)
    assert all(t.device.type == "meta" for t in op_cost.tensors(params))
    assert _port_specs(params) == _jax_specs(jparams)
    axes = models.param_axes(cfg)
    assert axes == jax_models.param_axes(jcfg)
    assert _port_specs(optimizer_abstract_state(params)) == _jax_specs(
        jax_adamw.optimizer_abstract_state(jparams))
    assert optimizer_state_axes(axes) == jax_adamw.optimizer_state_axes(axes)
    if cfg.encoder_only:
        with pytest.raises(ValueError, match="encoder-only"):
            models.decode_state_specs(cfg, 2, 64)
        return
    for B, S in ((2, 64), (128, 32_768)):
        state, state_axes = models.decode_state_specs(cfg, B, S)
        jstate, jaxes = jax_models.decode_state_specs(jcfg, B, S)
        assert _port_specs(state) == _jax_specs(jstate)
        assert state_axes == jaxes


# ----------------------------------------------------------------------
# the op count

def _reference_dot_flops(jcfg, B, S):
    """The reference's HLO dot FLOPs of a jitted impl="ref" forward, with
    its while-loop trip counts (`hlo_cost.execution_counts`)."""
    params = jax_models.abstract_params(jcfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    text = jax.jit(lambda p, b: jax_models.forward(
        jcfg, p, b, impl="ref")[0]).lower(params, batch).compile().as_text()
    comps = hlo_cost.parse_module(text)
    mult = hlo_cost.execution_counts(comps)
    return sum(mult.get(c.name, 0.0) * hlo_cost._op_flops(op, c)
               for c in comps.values() for op in c.ops if op.opcode == "dot")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "rwkv6-3b",
                                  "hymba-1.5b"])
def test_matmul_flops_equal_the_reference_hlo_dots(arch):
    B, S = 2, 64
    cfg = reduced(ARCHS[arch])
    batch = {"tokens": _meta((B, S), torch.int32)}
    counts = op_cost.analyze_ops(
        lambda p, b: models.forward(cfg, p, b, impl="ref")[0],
        models.abstract_params(cfg), batch)
    want = _reference_dot_flops(jax_reduced(JAX_ARCHS[arch]), B, S)
    assert counts["matmul_flops"] == want
    assert counts["flops"] > counts["matmul_flops"]
    assert set(counts["bytes_by_tag"]) <= set(op_cost.TAGS)


def test_a_dot_costs_two_m_n_k():
    """As the reference's test_hlo_cost_dot_flops_exact pins for XLA."""
    a, b = _meta((64, 256), torch.float32), _meta((256, 32), torch.float32)
    counts = op_cost.analyze_ops(lambda x, y: x @ y, a, b)
    assert counts["matmul_flops"] == counts["flops"] == 2 * 64 * 256 * 32
    assert counts["bytes"] == 4 * (64 * 256 + 256 * 32 + 64 * 32)
    assert counts["peak_bytes"] == 4 * 64 * 32


def _vjp_cost(fn, args, n_diff):
    def run(*a):
        out, vjp = torch.func.vjp(lambda *d: fn(*d, *a[n_diff:]),
                                  *a[:n_diff])
        return vjp(tuple(torch.empty(o.shape, dtype=o.dtype, device="meta")
                         for o in out))
    return op_cost.analyze_ops(run, *args)


_T = 64
_WKV = ((2, _T, 3, 8), torch.bfloat16)
_RECURRENCES = {
    # name: (dispatcher, plain version, args, differentiable args)
    "wkv": (lambda *a: wkv_ops.wkv6(*a, impl="ref"), wkv_ref.wkv6_reference,
            [_meta(*_WKV), _meta(*_WKV), _meta(*_WKV),
             _meta((2, _T, 3, 8), torch.float32), _meta((3, 8), torch.float32),
             _meta((2, 3, 8, 8), torch.float32)], 5),
    "ssm_ref": (lambda *a: ssm_ops.ssm_scan(*a, impl="ref"),
                ssm_ref.ssm_scan_reference,
                [_meta((2, _T, 12), torch.float32) for _ in range(2)]
                + [_meta((2, _T, 4), torch.float32) for _ in range(2)]
                + [_meta((2, 12, 4), torch.float32)], 4),
    # chunks of 256: T = 1,280 is 5 chunks, fitted through 2, 3 and 4
    "ssm_chunked": (lambda *a: ssm_ops.ssm_scan(*a, impl="chunked"),
                    ssm_ref.ssm_scan_chunked,
                    [_meta((2, 1280, 12), torch.float32) for _ in range(2)]
                    + [_meta((2, 1280, 4), torch.float32) for _ in range(2)]
                    + [_meta((2, 12, 4), torch.float32)], 4),
}


@pytest.mark.parametrize("name", sorted(_RECURRENCES))
def test_fitted_recurrence_equals_its_full_dispatch(name):
    region, plain, args, n_diff = _RECURRENCES[name]
    for got, want in (
            (op_cost.analyze_ops(region, *args),
             op_cost.analyze_ops(plain, *args)),
            (_vjp_cost(region, args, n_diff), _vjp_cost(plain, args, n_diff))):
        for k in ("flops", "matmul_flops", "bytes"):
            assert got[k] == want[k], k
    tag = "wkv" if name == "wkv" else "ssm"
    assert set(op_cost.analyze_ops(region, *args)["bytes_by_tag"]) == {tag}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-3b", "qwen3-0.6b"])
def test_regions_count_a_train_step_as_its_full_dispatch(arch, monkeypatch):
    """A reduced train step (remat, the regions' backward under
    `torch.func.grad`): the same FLOPs as with every region dispatched op
    by op (`active` patched to report no count)."""
    cfg = reduced(ARCHS[arch])
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
    fn, args = dryrun.step_and_args(cfg, shape)
    got = op_cost.analyze_ops(fn, *args)
    monkeypatch.setattr(op_cost, "active", lambda: None)
    want = op_cost.analyze_ops(fn, *args)
    assert got["matmul_flops"] == want["matmul_flops"]
    assert got["flops"] == want["flops"]
    assert got["bytes_by_tag"] and not want["bytes_by_tag"]


def test_attention_count_dispatches_the_same_ops_at_two_lengths():
    """One-shot attention: a reduced qwen3 forward on the chunked path
    dispatches as many ops at S = 2,048 as at 8,192; its matmul FLOPs
    grow as the one-shot shapes say."""
    cfg = reduced(ARCHS["qwen3-0.6b"])
    runs = {}
    for S in (2048, 8192):
        runs[S] = op_cost.analyze_ops(
            lambda p, b: models.forward(cfg, p, b, impl="plain")[0],
            models.abstract_params(cfg),
            {"tokens": _meta((1, S), torch.int32)})
    assert runs[2048]["dispatched"] == runs[8192]["dispatched"]
    assert runs[2048]["n_ops"] == runs[8192]["n_ops"]
    hq, hd = cfg.n_heads, cfg.head_dim
    attn = {S: 2 * 2 * hq * hd * S * S * cfg.n_layers for S in runs}
    assert runs[8192]["matmul_flops"] - attn[8192] == \
        4 * (runs[2048]["matmul_flops"] - attn[2048])


def test_window_band_of_the_chunked_path():
    """With a sliding window the chunked path visits a band of keys; the
    count prices the one-shot shapes over that band."""
    cfg = reduced(ARCHS["qwen3-0.6b"])
    S = 8192

    def count(window):
        c = dataclasses.replace(cfg, attn_window=window)
        return op_cost.analyze_ops(
            lambda p, b: models.forward(c, p, b, impl="plain")[0],
            models.abstract_params(c), {"tokens": _meta((1, S), torch.int32)})
    got, full = count(1024), count(0)
    band = L._window_band(S, 1024, 512, 1024)
    assert band == 2048
    per_layer = 2 * 2 * cfg.n_heads * cfg.head_dim * S
    assert full["matmul_flops"] - got["matmul_flops"] == \
        per_layer * (S - band) * cfg.n_layers


def test_counting_is_off_outside_a_count():
    assert op_cost.active() is None
    q = torch.randn(1, 8, 2, 4)
    out = L.attention(q, q, q, impl="ref")
    assert out.shape == q.shape and op_cost.active() is None


# ----------------------------------------------------------------------
# the roofline and the dry-run

def test_roofline_terms_follow_from_h100_constants():
    cfg, shape = ARCHS["qwen3-0.6b"], INPUT_SHAPES["prefill_32k"]
    counts = {"flops": 2e15, "bytes": 6.7e13, "collectives": {},
              "collective_bytes": 0.0, "bytes_by_tag": {"attention": 3.35e13},
              "matmul_flops": 1.9e15, "n_ops": 10, "peak_bytes": 3 * 2**30}
    roof = analysis.analyze(counts, arch="qwen3-0.6b",
                            shape_name="prefill_32k", mesh_name="1xH100",
                            n_chips=1, cfg=cfg, shape=shape,
                            compile_seconds=0.0, args_bytes=2**30,
                            out_bytes=2**30)
    assert roof.t_compute == 2e15 / 989e12 == 2e15 / H100_SXM.peak_flops_bf16
    assert roof.t_memory == 6.7e13 / 3.35e12
    assert roof.t_memory_kernel_adjusted == \
        (6.7e13 - 0.95 * 3.35e13) / 3.35e12
    assert roof.t_collective == 0.0 and H100_SXM.ici_bandwidth == 450e9
    assert roof.bottleneck == "memory"
    assert roof.temp_bytes == 2 * 2**30
    assert roof.peak_memory_bytes == 4 * 2**30 and roof.fits
    mf = analysis.model_flops(cfg, shape)
    assert roof.useful_flops_ratio == mf / 2e15
    assert roof.mfu_bound == (mf / 989e12) / roof.t_memory
    rec = roof.to_json()
    assert rec["mfu_bound"] == roof.mfu_bound and rec["fits"] is True


def test_dryrun_main_on_one_combo_and_a_skip(capsys):
    recs = dryrun.main(["--arch", "rwkv6-3b", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert out.startswith("OK   rwkv6-3b x decode_32k [1xH100]")
    assert "fits 80 GiB: yes" in out
    rec = recs[0]
    state, _ = models.decode_state_specs(ARCHS["rwkv6-3b"], 128, 32_768)
    n_args = sum(t.numel() * t.element_size() for t in op_cost.tensors(
        (models.abstract_params(ARCHS["rwkv6-3b"]), state)))
    assert rec["args_bytes"] == n_args + 2 * 128 * 4
    assert rec["bytes_by_tag"].keys() == {"wkv"}
    assert rec["flops_per_device"] >= rec["matmul_flops_per_device"] > 0
    roof, why = dryrun.lower_one("hubert-xlarge", "decode_32k")
    assert roof is None and "encoder-only" in why


def test_train_step_count_holds_params_optimizer_and_batch():
    """A reduced train step: the args are the params, AdamW state, step
    and batch; the outputs are fresh params and state of the same size."""
    cfg = reduced(ARCHS["smollm-360m"])
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
    fn, args = dryrun.step_and_args(cfg, shape)
    counts = op_cost.analyze_ops(fn, *args)
    n_params = models.param_count(cfg)
    specs, _ = make_batch_specs(cfg, 64, 2, "train")
    batch_bytes = sum(int(np.prod(s)) * torch.empty((), dtype=d)
                      .element_size() for s, d in specs.values())
    assert dryrun._storage_bytes(args) == \
        4 * n_params * 3 + 4 + 4 + batch_bytes
    params_out, opt_out, _ = counts["out"]
    assert dryrun._storage_bytes((params_out, opt_out)) == \
        4 * n_params * 3 + 4
    assert counts["peak_bytes"] >= dryrun._storage_bytes(counts["out"])
