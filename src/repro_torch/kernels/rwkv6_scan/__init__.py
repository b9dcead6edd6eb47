"""The WKV6 recurrence of RWKV-6: the plain PyTorch version, the wrapper
of the hand-written Hopper kernel (``csrc/wkv6.cu``) and the dispatch."""
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_reference
