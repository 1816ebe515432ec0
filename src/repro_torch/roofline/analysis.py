"""Roofline terms of a counted step (no card required).

The torch counterpart of ``repro.roofline.analysis``. Per (arch × shape ×
mesh) cell:

    compute term    = Σ flops / the card's peak for their type    [s]
    memory term     = HBM bytes / HBM bandwidth                   [s]
    collective term = collective bytes / link bandwidth           [s]

The flops, bytes and collective bytes are one device's, counted op by op
(``op_cost.count``: eager PyTorch runs each device's program as it is,
so there is no compiled module to read). ``collective_bytes`` of the JAX
package, a parse of the optimized HLO, is here the ``coll_bytes`` of an
``OpCost``.

Hardware model: NVIDIA H100 SXM5 80GB at 700 W (the power limit
``nvidia-smi`` reports on the card's machine), from NVIDIA's data sheet:
989 TFLOP/s dense bf16 (and f16) on the tensor cores; 67 TFLOP/s f32 on
the CUDA cores, which run the f32 products too because the port runs
with TF32 off, and every elementwise op and reduction; 3.35 TB/s of HBM;
450 GB/s of NVLink per direction per GPU within a node of 8; 50 GB/s per
GPU between nodes, one 400 Gb/s NDR port per GPU as in a DGX H100. The
collective term charges a cell's collective bytes against the link its
mesh needs: the between-nodes rate when the mesh spans more than one
node of 8 cards, NVLink otherwise (the counterpart of the JAX model's
"one ICI link": a ring keeps one send link busy; the record says which
rate it used). The compute term adds the times of the flops at their
own rates, as they share the SMs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .op_cost import OpCost

__all__ = ["HW", "RooflineCell", "analyze"]

HW = {
    "flops_bf16": 989e12,    # dense, tensor cores (f16 the same)
    "flops_f32": 67e12,      # CUDA cores (TF32 off)
    "hbm_bw": 3.35e12,
    "nvlink_bw": 450e9,      # per direction per GPU
    "internode_bw": 50e9,    # per GPU: one 400 Gb/s NDR port
    "gpus_per_node": 8,
}

# matmul operand dtypes the tensor cores take at the bf16 rate
_TENSOR_CORE = ("bfloat16", "float16")


@dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: dict = field(default_factory=dict)
    model_flops_global: float = 0.0   # 6·N·D (active params × tokens)
    memory_per_device: dict = field(default_factory=dict)
    torch_raw: dict = field(default_factory=dict)  # FlopCounterMode, global
    flops_by_kind: dict = field(default_factory=dict)
    matmul_flops_by_dtype: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)    # charged, not opened

    @property
    def flops_tensor_core(self) -> float:
        """The matmul flops whose operands the tensor cores take."""
        return sum(v for k, v in self.matmul_flops_by_dtype.items()
                   if k in _TENSOR_CORE)

    @property
    def t_compute(self) -> float:
        tc = self.flops_tensor_core
        return tc / HW["flops_bf16"] + (self.flops - tc) / HW["flops_f32"]

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HW["hbm_bw"]

    @property
    def collective_link(self) -> str:
        """``internode`` when the mesh spans more than one node, else
        ``nvlink``."""
        return "internode" if self.n_devices > HW["gpus_per_node"] else "nvlink"

    @property
    def t_collective(self) -> float:
        return sum(self.coll_bytes.values()) / HW[self.collective_link + "_bw"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (counted flops × devices): remat/redundancy waste."""
        total = self.flops * self.n_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilisation (against the bf16 peak) at the roofline
        bound."""
        peak = HW["flops_bf16"] * self.n_devices
        return (self.model_flops_global / self.t_bound) / peak \
            if self.t_bound else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "collective_link": self.collective_link,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
            "model_flops_global": self.model_flops_global,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu_bound": self.mfu_bound,
            "memory_per_device": self.memory_per_device,
            "flops_by_kind": self.flops_by_kind,
            "matmul_flops_by_dtype": self.matmul_flops_by_dtype,
            "kernels": self.kernels,
            "torch_raw": self.torch_raw,
            "hw": dict(HW),
        }


def analyze(arch, shape, mesh_name, n_devices, cost: OpCost,
            model_flops_global) -> RooflineCell:
    """The roofline terms of one device's counted step ``cost``."""
    return RooflineCell(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops=cost.flops, bytes_accessed=cost.bytes,
        coll_bytes={k: v for k, v in cost.coll_bytes.items() if v},
        model_flops_global=model_flops_global,
        memory_per_device=dict(cost.memory), torch_raw=dict(cost.torch_raw),
        flops_by_kind=dict(cost.flops_by_kind),
        matmul_flops_by_dtype=dict(cost.matmul_flops_by_dtype),
        kernels={k: dict(v) for k, v in cost.kernels.items()})
