"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of the cell, cut to a CPU size (`tiny`), under the cell's own limits,
once sound and once for each fault the cell can have: a step that
returns its state unchanged; half of each batch left out, the mean taken
over the rest; a token altered where it is produced.  (No cell spans
chips, so none can leave out an exchange between them.)"""
import pytest
import torch

from bench.tests import tiny

CNN_CELLS = tiny.cells("federation")
SERVE_CELLS = tiny.cells("serve")


def run(name):
    return tiny.driver(name).run(tiny.context(name))


@pytest.mark.parametrize("name", CNN_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.failed == 0


@pytest.mark.parametrize("name", CNN_CELLS)
def test_training_step_returns_its_state(name, monkeypatch):
    from repro_torch.core import overlay
    real = overlay.DecentralizedOverlay.local_phase

    def unchanged(self, stacked, batches, local_step):
        _, metrics = real(self, stacked, batches, local_step)
        return stacked, metrics
    monkeypatch.setattr(overlay.DecentralizedOverlay, "local_phase",
                        unchanged)
    assert not run(name).correct


@pytest.mark.parametrize("name", CNN_CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    from repro_torch.models import stigma_cnn
    real = stigma_cnn.loss_fn

    def half(cfg, params, images, labels):
        n = images.shape[0] // 2
        return real(cfg, params, images[:n], labels[:n])
    monkeypatch.setattr(stigma_cnn, "loss_fn", half)
    assert not run(name).correct


def decided(monkeypatch, commit):
    """Every consensus instance's outcome set to `commit`: an answer
    altered where it is produced."""
    from repro_torch.core import consensus
    real = consensus.PaxosSimulator.run_consensus

    def run_consensus(self, *args, **kw):
        tr = real(self, *args, **kw)
        tr.committed = commit
        return tr
    monkeypatch.setattr(consensus.PaxosSimulator, "run_consensus",
                        run_consensus)


@pytest.mark.parametrize("name", CNN_CELLS)
def test_round_aborted_with_a_majority(name, monkeypatch):
    decided(monkeypatch, False)
    out = run(name)
    assert out.failed > 0
    assert not out.correct


@pytest.mark.parametrize("name", [n for n in CNN_CELLS if tiny.cell_files(n)[
    0]["traffic_params"].get("dropout")])
def test_round_committed_without_a_majority(name, monkeypatch):
    """At a dropout rate (0.6) that leaves most rounds without a
    majority, every round commits."""
    decided(monkeypatch, True)
    ctx = tiny.context(name)
    ctx.cell["traffic_params"]["dropout"] = 0.6
    out = tiny.driver(name).run(ctx)
    assert out.failed > 0
    assert not out.correct


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_token_altered_where_produced(name, monkeypatch):
    from repro_torch.serving import engine
    real = engine.ServingEngine._sample
    calls = []

    def altered(self, logits):
        calls.append(1)
        tok = real(self, logits)
        return (tok + 1) % len(logits) if len(calls) % 7 == 0 else tok
    monkeypatch.setattr(engine.ServingEngine, "_sample", altered)
    assert not run(name).correct


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_decode_step_returns_its_state(name, monkeypatch):
    from repro_torch.models import rwkv6
    real = rwkv6.decode_step

    def stale(cfg, params, state, tokens, pos):
        logits, _ = real(cfg, params, state, tokens, pos)
        return logits, {k: v.clone() for k, v in state.items()}
    monkeypatch.setattr(rwkv6, "decode_step", stale)
    assert not run(name).correct


@pytest.mark.cuda
@pytest.mark.parametrize("name", CNN_CELLS + SERVE_CELLS)
def test_control_fails_on_the_card(name):
    """The control (TF32 for the CNN, float8 products for the served
    model) in the program's place, at the cell's own size on three seeds,
    comes out not correct under the cell's limits each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import time
    from bench.common import Context, checks_from
    cell, conf = tiny.cell_files(name)
    drv = tiny.driver(name)
    kw = {"verified_pull": False} if cell["driver"] == "serve" else {}
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = Context(name=name, cell=cell, config=conf, seed=seed,
                      seconds=10.0, trace=False,
                      device=torch.device("cuda"), t_start=time.time())
        out = drv.run(ctx, control=True, **kw)
        ctl = checks_from(out.counters["control"],
                          {k: v for k, v in cell["limits"].items()
                           if k in out.counters["control"]})
        print(name, seed, "program", out.counters["numbers"],
              "control", out.counters["control"])
        assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
        assert not all(c.holds for c in ctl), ctl
