"""Target-hardware constants and the calibration of the device a run uses.

The port's copy of ``repro.roofline.hw``.  ``V5E`` is the reference's
data-sheet record for the TPU the JAX package targets; ``H100`` is NVIDIA's
data-sheet record for the card this package targets.  ``calibrate_host``
is their measured twin for the device a perf run actually uses: perf
baselines (DESIGN.md §9) normalise wall-clock against the calibrated peaks,
so the judged quantity is "multiples of this device's roofline", not raw
seconds.

On the CPU the calibration is the reference's, line for line (a numpy
memcpy and a float32 GEMM).  On a CUDA device it measures the card: a
device-to-device copy of a buffer far larger than the 50 MB L2 (an
L2-resident copy would read above HBM and deflate every roofline share),
and a float32 ``torch.matmul`` with TF32 off, both timed with CUDA events.
"""

import dataclasses
import functools
import statistics
import time

import torch


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_bf16_flops: float  # per chip
    hbm_bw: float  # bytes/s per chip
    ici_bw: float  # bytes/s per link (intra-pod)
    inter_pod_bw: float  # bytes/s per link (optical tier)
    hbm_bytes: float


V5E = HW(
    name="tpu-v5e",
    peak_bf16_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    inter_pod_bw=25e9,
    hbm_bytes=16e9,
)

# NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data sheet): dense
# bf16 tensor-core rate, HBM3, NVLink 4 one direction, one NDR InfiniBand
# port a GPU.
H100 = HW(
    name="nvidia-h100-sxm5-80gb",
    peak_bf16_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    inter_pod_bw=50e9,
    hbm_bytes=80e9,
)

# The records a roofline may divide by, by the name the CLIs take.
RECORDS = {"h100": H100, "v5e": V5E}

# Probe sizes by device type: (copy MiB, GEMM k).  The card's copy is 1 GiB,
# twenty times its L2; its GEMM k = 8192 keeps the float32 product
# compute-bound.
_PROBE_SIZES = {"cpu": (64, 384), "cuda": (1024, 8192)}


def _copy_bandwidth(nbytes: int, repeats: int) -> float:
    """Measured memcpy bandwidth in bytes/s (read + write counted)."""
    import numpy as np

    src = np.zeros(nbytes, dtype=np.uint8)
    dst = np.empty_like(src)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        times.append(time.perf_counter() - t0)
    return 2.0 * nbytes / float(np.median(times))


def _gemm_flops(k: int, repeats: int) -> float:
    """Measured dense f32 GEMM rate in FLOP/s (the host 'compute peak')."""
    import numpy as np

    a = np.ones((k, k), dtype=np.float32)
    b = np.ones((k, k), dtype=np.float32)
    a @ b  # BLAS thread-pool / page-fault warmup outside the timed region
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        a @ b
        times.append(time.perf_counter() - t0)
    return 2.0 * k**3 / float(np.median(times))


def _event_median_s(fn, repeats: int) -> float:
    """Median seconds of ``fn`` on the current stream by CUDA events, one
    warmup call outside the clock."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def _card_copy_bandwidth(device: torch.device, nbytes: int, repeats: int) -> float:
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    src = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    t = _event_median_s(lambda: dst.copy_(src), repeats)
    del src, dst
    return 2.0 * nbytes / t


def _card_gemm_flops(device: torch.device, k: int, repeats: int) -> float:
    """Dense float32 ``torch.matmul`` rate in FLOP/s, TF32 off."""
    a = torch.ones((k, k), dtype=torch.float32, device=device)
    b = torch.ones((k, k), dtype=torch.float32, device=device)
    out = torch.empty_like(a)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = _event_median_s(lambda: torch.matmul(a, b, out=out), repeats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    del a, b, out
    return 2.0 * k**3 / t


def _resolve(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "calibrate_host(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to calibrate the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"calibrate_host runs on cuda or cpu, not {dev}")
    return dev


def calibrate_host(
    *,
    device="cuda",
    copy_mb: "int | None" = None,
    gemm_k: "int | None" = None,
    repeats: int = 5,
) -> HW:
    """Measure ``device``'s effective peaks and return them as an ``HW``.

    Both probes are median-of-``repeats`` with a warmup (the measurement
    contract of ``repro_torch.perf.measure``, inlined here so roofline
    stays importable without the perf package).  ``copy_mb`` and
    ``gemm_k`` default by device type (``_PROBE_SIZES``).  The link-tier
    fields reuse the copy bandwidth (one device has no slower tier), and
    ``peak_bf16_flops`` holds the float32 GEMM rate, as the reference's
    host record does.  On
    the CPU ``name`` is ``host-calibrated`` and ``hbm_bytes`` 0.0; on the
    card ``name`` is ``torch.cuda.get_device_name`` and ``hbm_bytes`` its
    memory.  Cached per device and sizes: every case of a perf run is
    normalised against the same peaks.
    """
    dev = _resolve(device)
    mb, k = _PROBE_SIZES[dev.type]
    return _calibrate(str(dev), mb if copy_mb is None else int(copy_mb), k if gemm_k is None else int(gemm_k),
                      int(repeats))


@functools.lru_cache(maxsize=None)
def _calibrate(device: str, copy_mb: int, gemm_k: int, repeats: int) -> HW:
    dev = torch.device(device)
    if dev.type == "cpu":
        bw = _copy_bandwidth(copy_mb << 20, repeats)
        fl = _gemm_flops(gemm_k, repeats)
        return HW(name="host-calibrated", peak_bf16_flops=fl, hbm_bw=bw, ici_bw=bw, inter_pod_bw=bw,
                  hbm_bytes=0.0)
    with torch.cuda.device(dev):
        bw = _card_copy_bandwidth(dev, copy_mb << 20, repeats)
        fl = _card_gemm_flops(dev, gemm_k, repeats)
        torch.cuda.empty_cache()  # hand the probes' 2 GiB back to the card
        props = torch.cuda.get_device_properties(dev)
        return HW(name=torch.cuda.get_device_name(dev), peak_bf16_flops=fl, hbm_bw=bw, ici_bw=bw,
                  inter_pod_bw=bw, hbm_bytes=float(props.total_memory))
