"""Observability: profiler traces, roofline accounting against device peaks.

The reference's observability is an env toggle + wall-clock helper
(SURVEY.md §5.1); here the equivalents are `jax.profiler` traces and a
roofline reporter that situates measured throughput against the device's
published ceilings. A device kind missing from `PEAKS` is an error: a
roofline against some other card's peak would be a wrong number.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import jax

# Published dense peaks per `jax.Device.device_kind`.
# H100 SXM: NVIDIA H100 Tensor Core GPU data sheet — 989 TFLOP/s dense
# bf16/fp16, 3.35 TB/s HBM3 (80 GB), at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "hbm_bw": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
    },
}


def device_kind() -> str:
    return jax.devices()[0].device_kind


def chip_spec(kind: Optional[str] = None) -> dict:
    """Ceilings for device `kind` (default: the first JAX device's)."""
    kind = kind or device_kind()
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add a sourced "
            "row to fa2_jax.utils.profiling.PEAKS")
    return PEAKS[kind]


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context; open the logdir with TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@dataclass
class RooflineReport:
    time_s: float
    flops: float
    bytes_moved: float
    chip: str

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.time_s / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.time_s / 1e9

    @property
    def compute_bound(self) -> bool:
        spec = chip_spec(self.chip)
        return (self.flops / spec["bf16_flops"]) > (self.bytes_moved / spec["hbm_bw"])

    @property
    def utilization(self) -> float:
        """Fraction of the binding resource's ceiling achieved."""
        spec = chip_spec(self.chip)
        t_ideal = max(self.flops / spec["bf16_flops"],
                      self.bytes_moved / spec["hbm_bw"])
        return t_ideal / self.time_s

    def summary(self) -> str:
        bound = "compute" if self.compute_bound else "bandwidth"
        return (f"{self.achieved_tflops:.1f} TFLOP/s, {self.achieved_gbps:.0f} GB/s "
                f"({bound}-bound on {self.chip}; {self.utilization*100:.0f}% of roofline)")


def roofline(time_s: float, flops: float, bytes_moved: float,
             chip: Optional[str] = None) -> RooflineReport:
    kind = chip or device_kind()
    chip_spec(kind)  # unknown kinds fail here, not at first use
    return RooflineReport(time_s, flops, bytes_moved, kind)
