"""Roofline terms of one counted step, priced at H100 constants.

The counterpart of the reference's ``launch/analysis.py``.  Its input is
the op count of `launch.op_cost` (``analyze_ops``) instead of a compiled
XLA module, and its constants are the card's,
`continuum.resources.H100_SXM`: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM,
450 GB/s NVLink one way.  Every number it gives is modelled from those
constants, not measured.

Collectives.  Ranks lie row-major over the mesh, eight to an HGX H100
node (node = rank // 8).  A collective whose group stays inside one node
goes over NVLink at ``H100_SXM.ici_bandwidth``; one whose group crosses
nodes goes at the node's per-GPU network rate, `NETWORK_BANDWIDTH`.  The
16-wide "model" axis spans two nodes, so its collectives take the
network.  The wire bytes of each kind and link are modelled (the ring
formulas of `op_cost._wire_bytes`), not measured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.continuum.resources import H100_SXM

HBM_BYTES = H100_SXM.hbm_gb * 2**30      # the 80 GiB a step must fit
GPUS_PER_NODE = 8                        # an HGX H100 node
# One 400 Gb/s NDR InfiniBand port a GPU in an HGX H100 node (NVIDIA's
# DGX H100 reference: 8 ConnectX-7 ports, one per GPU): 50 GB/s one way.
NETWORK_BANDWIDTH = 400e9 / 8
LINKS = ("nvlink", "network")


def link_of(ranks) -> str:
    """"nvlink" when every rank of the group sits in one node, else
    "network"."""
    return "nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1 \
        else "network"


def link_bytes(collectives: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Wire bytes a device moves over each link, summed over the kinds."""
    return {link: sum(v.get(link, 0.0) for v in collectives.values())
            for link in LINKS}


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token/seq


@dataclasses.dataclass
class Roofline:
    """The reference's fields, less ``xla_flops_per_device`` (there is no
    XLA here), plus the count's matmul FLOPs, op count and the memory
    split of its ``memory_analysis``.  ``compile_seconds`` holds the
    count's wall time."""
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, Dict[str, float]]
    model_flops_global: float
    peak_memory_bytes: float
    compile_seconds: float
    variant: str = ""
    bytes_by_tag: Dict[str, float] = dataclasses.field(default_factory=dict)
    matmul_flops_per_device: float = 0.0
    n_ops: float = 0.0
    args_bytes: float = 0.0
    temp_bytes: float = 0.0
    out_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / H100_SXM.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / H100_SXM.hbm_bandwidth

    @property
    def t_memory_kernel_adjusted(self) -> float:
        """Memory term if the tagged attention/wkv/ssm regions ran as the
        hand-written kernels (block intermediates on chip): their HBM
        traffic collapses to ~the q/k/v/o tensors, approximated as 5%% of
        the plain path's traffic, as in the reference."""
        tagged = sum(self.bytes_by_tag.values())
        return (self.bytes_per_device - 0.95 * tagged) / H100_SXM.hbm_bandwidth

    @property
    def t_collective_by_link(self) -> Dict[str, float]:
        """Seconds of each link's wire bytes at its rate."""
        b = link_bytes(self.collectives)
        return {"nvlink": b["nvlink"] / H100_SXM.ici_bandwidth,
                "network": b["network"] / NETWORK_BANDWIDTH}

    @property
    def t_collective(self) -> float:
        return sum(self.t_collective_by_link.values())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-device counted flops * chips): <1 means remat,
        elementwise work or padding the analytic model leaves out."""
        counted = self.flops_per_device * self.n_chips
        return self.model_flops_global / max(counted, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU implied by the dominant term."""
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        t_model = (self.model_flops_global
                   / (self.n_chips * H100_SXM.peak_flops_bf16))
        return t_model / max(t_step, 1e-30)

    @property
    def fits(self) -> bool:
        """args + temp + out within the card's 80 GiB."""
        return self.peak_memory_bytes <= HBM_BYTES

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_memory_kernel_adjusted=self.t_memory_kernel_adjusted,
                 t_collective=self.t_collective,
                 t_collective_by_link=self.t_collective_by_link,
                 bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 mfu_bound=self.mfu_bound, fits=self.fits)
        return d


def analyze(counts: Dict, *, arch: str, shape_name: str, mesh_name: str,
            n_chips: int, cfg: ModelConfig, shape: InputShape,
            compile_seconds: float, variant: str = "",
            args_bytes: float = 0.0, out_bytes: float = 0.0) -> Roofline:
    """A `Roofline` from an ``op_cost.analyze_ops`` result.  Memory, the
    counterpart of XLA's ``memory_analysis``: args (`args_bytes`: params,
    optimizer state, batch, cache), out (`out_bytes`) and temp, the
    count's peak of live storages less the outputs, so that args + temp
    + out is the step's modelled peak."""
    temp = max(float(counts["peak_bytes"]) - out_bytes, 0.0)
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, n_chips=n_chips,
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["bytes"]),
        collective_bytes_per_device=float(counts["collective_bytes"]),
        collectives=counts["collectives"],
        model_flops_global=model_flops(cfg, shape),
        peak_memory_bytes=float(args_bytes + temp + out_bytes),
        compile_seconds=compile_seconds,
        variant=variant,
        bytes_by_tag=dict(counts.get("bytes_by_tag", {})),
        matmul_flops_per_device=float(counts.get("matmul_flops", 0.0)),
        n_ops=float(counts.get("n_ops", 0)),
        args_bytes=float(args_bytes), temp_bytes=temp,
        out_bytes=float(out_bytes),
    )
