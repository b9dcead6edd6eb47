"""The diagonal selective scan of hymba's mamba branch: the plain
PyTorch versions, the wrapper of the hand-written Hopper kernel
(``csrc/ssm_scan.cu``) and the dispatch."""
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import (
    ssm_scan_chunked, ssm_scan_reference,
)
