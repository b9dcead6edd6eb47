"""STIGMA decentralized-ML overlay in PyTorch.

  overlay.py     DecentralizedOverlay: local training + consensus-gated
                 merges (eager `round()` + batched `run_rounds()`)
  merges/        pluggable merge engine: protocol, registry, toolkit,
                 mean | ring | hierarchical | quantized | secure_mean,
                 the robust merges and the partial merge
  device_tier.py the device tier: each institution's chunked, exact
                 sweep over its simulated personal devices
  consensus.py   Paxos 3-phase-commit simulator + ConsensusGate
  secure_agg.py  additive-mask MPC aggregation (uses kernels/secure_agg)
  registry.py    permissioned-DLT model registry over merkle.py
  scheduler.py   continuum placement + the accuracy<->time knob
"""
from repro_torch.core.consensus import (
    ConsensusGate, PaxosSimulator, ProtocolParams, measure,
)
from repro_torch.core.device_tier import (
    DEVICE_FRAC_BITS, DeviceTierConfig, device_sweep, device_sweep_ids,
    device_sweep_reference, device_sweep_stacked, encode_update,
    make_device_local_step, make_device_state, zero_stale,
)
from repro_torch.core.merges import (
    BlockSchedule, BlockSpec, MergeContext, MergeStrategy, available_merges,
    get_merge, gossip_shift, register_merge,
)
from repro_torch.core.overlay import (
    DecentralizedOverlay, OverlayConfig, replicate_params, stack_params,
    unstack_params,
)
from repro_torch.core.registry import (
    ModelRegistry, RoundRecord, fingerprint_pytree,
)
from repro_torch.core.scheduler import (
    ContinuumScheduler, accuracy_to_width, time_fraction_for_accuracy,
)
