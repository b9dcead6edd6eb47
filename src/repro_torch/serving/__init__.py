from repro_torch.serving.engine import (
    Request, ServeConfig, ServingEngine, make_serve_step,
)
from repro_torch.serving.federated import (
    FederatedServer, FingerprintMismatchError, LedgerRootMismatchError,
    ModelStore, ModelUnavailableError, NoCommittedModelError,
    ServingVerificationError, TamperedLedgerError, VerifiedModel,
    latest_committed, plan_serving, pull_from_snapshot, pull_latest_model,
    serving_workload,
)
