"""STIGMA decentralized-ML overlay in PyTorch.

  overlay.py     DecentralizedOverlay: local training + consensus-gated
                 merges (eager `round()` + batched `run_rounds()`)
  merges/        pluggable merge engine: protocol, registry, toolkit,
                 mean | secure_mean
  consensus.py   Paxos 3-phase-commit simulator + ConsensusGate
  secure_agg.py  additive-mask MPC aggregation (uses kernels/secure_agg)
  registry.py    permissioned-DLT model registry over merkle.py
"""
