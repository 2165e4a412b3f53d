"""Three-term roofline of one step on an H100 SXM 80 GB (no hardware).

Counterpart of `repro/roofline/analyze.py`:

  compute    = FLOPs_per_device / peak FLOP/s (by dtype)
  memory     = bytes_per_device / HBM bandwidth
  collective = wire_bytes_per_device / link bandwidth (NVLink or between
               hosts, by where the collective's group lies)

The statistics come from `roofline/op_stats.py`: the step as the port
runs it eagerly, one op at a time, on the local shards of rank 0.  Wire
bytes use the reference's ring models (`collective_bytes`):

  all-reduce      2 * size * (N-1)/N        (reduce-scatter + all-gather)
  all-gather      out_size * (N-1)/N
  reduce-scatter  out_size * (N-1)
  all-to-all      size * (N-1)/N
  collective-permute / broadcast  size

Hardware model, one H100 SXM 80 GB (NVIDIA's data sheet, dense rates, at
the card's full 700 W):
"""
from __future__ import annotations

import dataclasses

#: dense bf16 / fp16 tensor-core peak, FLOP/s
PEAK_BF16 = 989.4e12
#: float32 peak outside the tensor cores, FLOP/s: TF32 is off in the port
#: (`torch.backends.cuda.matmul.allow_tf32 = False`), so a float32 matmul
#: is charged at this rate
PEAK_F32 = 66.9e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: NVLink 4, bytes/s each way per card, within a host of 8 cards
NVLINK_BW = 450e9
#: between hosts, bytes/s per card (one 400 Gb/s NIC a card)
HOST_BW = 50e9
#: HBM capacity, bytes
HBM_BYTES = 80e9
#: cards a host; rank r lies on host r // CARDS_PER_HOST
CARDS_PER_HOST = 8

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Per-device wire bytes of one collective of `size` output bytes over
    a group of `n` ranks (the reference's ring models)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        return float(size) * (n - 1)
    return float(size)  # collective-permute, broadcast


def within_host(ranks) -> bool:
    """Whether every rank of a group lies on one host (rank r on host
    r // CARDS_PER_HOST)."""
    return len({r // CARDS_PER_HOST for r in ranks}) <= 1


@dataclasses.dataclass
class Roofline:
    """The reference's record, field for field.  `flops` / `bytes_accessed`
    / `wire_bytes` are per device.  `raw_flops`, `raw_bytes` and
    `n_whiles` have no counterpart and are 0: eager torch runs every
    loop iteration as its own ops, so there is no loop body counted once
    to correct (the reference keeps XLA's uncorrected `cost_analysis`
    there)."""
    flops: float
    bytes_accessed: float
    wire_bytes: float
    n_devices: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    collectives_by_op: dict
    peak_memory_bytes: float = 0.0
    raw_flops: float = 0.0
    raw_bytes: float = 0.0
    model_flops_global: float = 0.0
    model_to_hlo_ratio: float = 0.0
    n_whiles: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(stats, n_devices: int, model_flops_global: float = 0.0
            ) -> Roofline:
    """The roofline of an `op_stats.OpStats`: the compute term charges
    16-bit FLOPs at the tensor-core peak and the rest at the float32
    peak; the collective term charges each collective at NVLink speed
    when its group lies within one host, at the between-host speed
    otherwise."""
    t_c = stats.flops_16 / PEAK_BF16 + (stats.flops - stats.flops_16) / PEAK_F32
    t_m = stats.bytes / HBM_BW
    t_n = stats.wire_intra / NVLINK_BW + stats.wire_inter / HOST_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_n}
    ratio = (model_flops_global / (stats.flops * n_devices)
             if stats.flops and model_flops_global else 0.0)
    return Roofline(flops=stats.flops, bytes_accessed=stats.bytes,
                    wire_bytes=stats.wire_intra + stats.wire_inter,
                    n_devices=n_devices, t_compute=t_c, t_memory=t_m,
                    t_collective=t_n, bottleneck=max(terms, key=terms.get),
                    collectives_by_op=dict(stats.wire_by_op),
                    peak_memory_bytes=float(stats.peak_bytes),
                    model_flops_global=model_flops_global,
                    model_to_hlo_ratio=ratio)
