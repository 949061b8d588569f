"""What the program knows about the machine it runs on, in one place.

- **Backend.** The hand-written tile kernel runs compiled only where JAX's
  backend is ``gpu`` (:func:`on_gpu`).  A kernel runs in interpret mode only
  when a caller passes ``interpret=True``, which only tests do.
- **Peaks.** Published rates per ``device_kind``, with their source.  A
  reported rate or roofline share reads the row of the device it ran on
  (:func:`device_peaks`); a device not in the table raises.  Cost models
  that make decisions read :data:`MODEL_TARGET` by name, so a plan is the
  same on the CPU (tests) and on the card.
- **Compile cache** (:func:`setup_compile_cache`).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published dense peak rates of one accelerator part."""

    kind: str                 # jax.devices()[0].device_kind
    bf16_flops: float
    tf32_flops: float
    f32_flops: float          # outside the tensor cores
    hbm_bytes_per_s: float
    link_bytes_per_s: float   # one direction, to each other device
    source: str

    def flops(self, itemsize: int, precision: str = "default") -> float:
        """Peak for tiles of ``itemsize`` bytes at ``precision``: 2-byte
        tiles run bf16; f32 tiles run TF32 at ``'default'`` and true f32
        at ``'highest'``."""
        if itemsize == 2:
            return self.bf16_flops
        return self.f32_flops if precision == "highest" else self.tf32_flops


H100_SXM = "NVIDIA H100 80GB HBM3"

PEAKS = {
    H100_SXM: DevicePeaks(
        kind=H100_SXM, bf16_flops=989e12, tf32_flops=495e12,
        f32_flops=67e12, hbm_bytes_per_s=3.35e12, link_bytes_per_s=450e9,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense "
               "rates at the 700 W limit; NVLink 900 GB/s = 450 each way",
    ),
}

# The device the decision-making cost models are written for.
MODEL_TARGET = PEAKS[H100_SXM]


def peaks_for(kind: str) -> DevicePeaks:
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(PEAKS)}") from None


def backend() -> str:
    import jax

    return jax.default_backend()


def on_gpu() -> bool:
    return backend() == "gpu"


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def device_line() -> str:
    d = device_info()
    return f"device: {d['platform']} {d['kind']} x{d['count']}"


def nvidia_smi_line() -> str:
    """Each card's name and power limit, as nvidia-smi gives them; a card
    set below its maximum runs slower under load, so this goes beside
    every number measured on it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(what: str) -> None:
    """Raise unless JAX runs on a GPU: measurement paths fail, they do not
    fall back to timing the CPU."""
    b = backend()
    if b != "gpu":
        raise RuntimeError(f"{what} measures the GPU, but JAX's backend is "
                           f"{b!r}")


def device_peaks() -> DevicePeaks:
    """Peak row of the device this process runs on."""
    return peaks_for(device_info()["kind"])


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``, from the package's location."""
    return str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")


def setup_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself); otherwise keep the persistent compile cache in
    :func:`default_cache_dir`.  Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
