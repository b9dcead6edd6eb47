"""The plain references agree with the program at tiny sizes on the CPU.
This test imports both; the references themselves import nothing of the
program."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.reference import cnn, ledger, prg, rwkv6

from repro_torch import random as prng
from repro_torch.chaos.schedule import Dropout
from repro_torch.configs.stigma_cnn import STIGMA_CNN
from repro_torch.core.registry import Transaction, fingerprint_pytree
from repro_torch.core.secure_agg import seed_from_key
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.secure_agg import masking
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as prog_rwkv6
from repro_torch.models import stigma_cnn

KEYS = [np.array([0, 7], np.uint32), np.array([0x9E3779B9, 3], np.uint32),
        np.array([4294967295, 2147483648], np.uint32)]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_prg_keys(key):
    assert np.array_equal(prg.split(key), prng.split(key))
    _, k2 = prng.split(key)
    assert prg.merge_seed(key) == int(seed_from_key(k2)[0])


@pytest.mark.parametrize("seed", [0, 123456789, 0xFFFFFFFF])
def test_prg_dp_normals(seed):
    want = masking.normal_block(seed, torch.arange(5)[:, None],
                                torch.arange(4099)[None, :]).numpy()
    got = prg.dp_normals(seed, 5, 4099)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 12345, 0x7FFFFFFF])
def test_prg_dropout_schedule(seed):
    for r in (0, 1, 999, 123456):
        assert np.array_equal(prg.dropout_up(seed, 0.3, r, 32),
                              Dropout(0.3, seed=seed).faults(r, 32)
                              .participation)


def test_cnn_forward_and_loss():
    cfg = dataclasses.replace(STIGMA_CNN, image_size=16)
    g = torch.Generator().manual_seed(3)
    params = stigma_cnn.init_params(cfg, g)
    imgs = torch.randn((6, 16, 16, 3), generator=g)
    labels = torch.randint(0, 2, (6,), generator=g)
    want, _ = stigma_cnn.loss_fn(cfg, params, imgs, labels)
    assert torch.allclose(cnn.loss_fn(params, imgs, labels), want,
                          rtol=1e-6, atol=0)
    assert torch.allclose(cnn.forward(params, imgs),
                          stigma_cnn.forward(cfg, params, imgs),
                          rtol=1e-5, atol=1e-6)


def test_cnn_ravel_order_and_fingerprint():
    model = {"image_size": 16, "in_channels": 3, "channels": [32, 64, 128],
             "n_classes": 2}
    g = torch.Generator().manual_seed(1)
    leaves = cnn.make_params(model, 2, g, torch.device("cpu"))
    tree = cnn.from_leaves([t[1] for t in leaves])
    assert fingerprint_pytree(tree) == ledger.fingerprint(
        [t[1].numpy() for t in leaves], cnn.TREEDEF)
    from repro_torch.pytree import tree_flatten
    flat, _ = tree_flatten(tree)
    assert all(a is b for a, b in zip(flat, cnn.leaves(tree)))


def test_tx_hash():
    tx = Transaction(index=3, prev_hash="ab" * 32, kind="rolling_update",
                     institution="overlay", model_fingerprint="cd" * 32,
                     arch_family="cnn", parents=("a", "b"),
                     metadata='{"round": 1}', timestamp=3.0)
    assert ledger.tx_hash(tx) == tx.hash()


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_wkv(T):
    g = torch.Generator().manual_seed(T)
    H, hd = 3, 8
    r, k, v = (torch.randn((T, H, hd), generator=g) for _ in range(3))
    w = torch.rand((T, H, hd), generator=g) * 0.5 + 0.5
    w[T // 2] = 0.0
    u = torch.randn((H, hd), generator=g)
    want, _ = wkv_ref.wkv6_reference(r[None], k[None], v[None], w[None], u,
                                     torch.zeros((1, H, hd, hd)))
    got = rwkv6.wkv(r, k, v, w, u)
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)


CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                     "rwkv6-3b.json").read_text())
TINY_RWKV = {**CONFIG["model"], **CONFIG["tiny"]}


def test_rwkv6_logits_match_the_program_in_fp32(monkeypatch):
    """The reference's logits equal the program's prefill with float32
    compute, on the benchmark's own weights."""
    from bench.drivers import serve
    m = TINY_RWKV
    params = rwkv6.make_params(m, 5, torch.device("cpu"))
    cfg = serve.model_config({**CONFIG, "model": m})
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    toks = torch.randint(0, 512, (1, 150), generator=torch.Generator()
                         .manual_seed(2))
    want, _, _ = prog_rwkv6.prefill(cfg, params, {"tokens": toks}, 160)
    got = rwkv6.logits_at(m, params, toks[0].tolist(), range(150))
    torch.testing.assert_close(got, want[0], rtol=2e-4, atol=2e-4)


def test_control_is_lower_precision():
    """The float8 control moves the logits far more than float32
    rounding does."""
    m = TINY_RWKV
    params = rwkv6.make_params(m, 6, torch.device("cpu"))
    toks = list(range(40))
    ref = rwkv6.logits_at(m, params, toks, range(40))
    low = rwkv6.logits_at(m, params, toks, range(40), lower=True)
    assert (ref - low).abs().max() > 1e-2
