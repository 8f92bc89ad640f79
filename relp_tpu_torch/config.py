"""Solver configuration of the PyTorch port.

The same fields, defaults and validation as ``relp_tpu.config.SolverConfig``
(config.py:24-231), so a configuration moves between the two packages
unchanged.  Two differences:

* ``platform`` names the torch device: ``None`` means ``"cuda"``, and
  ``"cpu"`` must be asked for.  Nothing falls back to the CPU silently.
* There is no ``jax_enable_x64`` switch: f64 is native on CUDA and the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch


@dataclasses.dataclass
class SolverConfig:
    """Runtime configuration of the simplex engine (see relp_tpu.config)."""

    # Working dtype of the carried state ("float32" fast path, "float64"
    # escalation rung); exact certification guarantees the answer.
    dtype: str = "float32"
    # dtype of the tableau copy read by the pricing / steepest-edge scans
    # ("float32" | "bfloat16" | "same").
    scan_dtype: str = "float32"
    # "native" | "df32" (double-float carry; asked for, never entered by
    # the escalation ladder, since f64 is native on CUDA and the CPU).
    carry: str = "native"
    # "dantzig" | "steepest" | "first" | "first_memory".
    pricing: str = "steepest"

    opt_tol: float = 1e-9
    pivot_tol: float = 1e-9
    feas_tol: float = 1e-9
    phase1_tol: float = 1e-8
    zero_tol: float = 1e-11

    refactor_period: int = 60
    # Pivots per device chunk between host checks (<= refactor_period
    # unless device_refactor).
    chunk_size: int = 60
    device_refactor: bool = False
    max_iterations: int = 200_000
    bland_threshold: int = 300
    # Row/column padding multiple of the lowered arrays; 128 keeps the
    # lowered shapes equal to the JAX package's.
    pad_to: int = 128
    # "dense" (explicit inverse) | "lu" (LU factors + eta ring).
    basis_inverse: str = "dense"
    gamma_refresh_period: int = 1
    # "auto" | "device" | "host_sparse" ("auto" picks the sparse host
    # backend only on the CPU: simplex.host_sparse.should_use_host_sparse).
    backend: str = "auto"
    phase1: str = "two_phase"

    certify: bool = True
    exact_cleanup: bool = True
    exact_cleanup_budget: int = 2_000
    exact_cleanup_time_s: float = 600.0

    presolve: bool = True
    prescale: bool = False

    # Torch device: None means "cuda"; "cpu" only when asked for.
    platform: Optional[str] = None

    # Both kept so configurations move between packages; neither selects
    # anything.  The port's steepest edge pricing always goes through
    # relp_tpu_torch.ops.fused_price_scan, and solve_batch runs its cold
    # phases through the batched-pivot kernels (relp_tpu_torch.ops.
    # batch_pivot) wherever parallel.batch.megakernel_applicable holds.
    pallas_scan: bool = False
    pallas_batch: bool = False
    dual_restart: bool = True
    debug_validate: bool = False

    def __post_init__(self) -> None:
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.scan_dtype not in ("float32", "bfloat16", "same"):
            raise ValueError(f"unsupported scan_dtype {self.scan_dtype!r}")
        if self.basis_inverse not in ("dense", "lu"):
            raise ValueError(f"unsupported basis_inverse {self.basis_inverse!r}")
        if self.carry not in ("native", "df32"):
            raise ValueError(f"unsupported carry {self.carry!r}")
        if self.carry == "df32" and (
            self.dtype != "float32" or self.basis_inverse != "dense"
        ):
            raise ValueError(
                "carry='df32' requires dtype='float32' and "
                "basis_inverse='dense'"
            )
        if self.backend not in ("auto", "device", "host_sparse"):
            raise ValueError(f"unsupported backend {self.backend!r}")
        if self.phase1 not in ("two_phase", "bigm"):
            raise ValueError(f"unsupported phase1 {self.phase1!r}")
        # dataclasses.replace() rebuilds from the (possibly f32-clamped)
        # fields, so the driver's dtype escalation restores these.
        self.requested_tolerances = {
            "opt_tol": self.opt_tol,
            "pivot_tol": self.pivot_tol,
            "feas_tol": self.feas_tol,
            "phase1_tol": self.phase1_tol,
        }
        if self.dtype == "float32" and self.carry == "df32":
            self.opt_tol = max(self.opt_tol, 1e-9)
            self.pivot_tol = max(self.pivot_tol, 1e-8)
            self.feas_tol = max(self.feas_tol, 1e-9)
            self.phase1_tol = max(self.phase1_tol, 1e-8)
        elif self.dtype == "float32":
            # Tolerances below f32 resolution are noise; certification and
            # the f64 rung backstop correctness.
            self.opt_tol = max(self.opt_tol, 1e-5)
            self.pivot_tol = max(self.pivot_tol, 1e-5)
            self.feas_tol = max(self.feas_tol, 1e-5)
            self.phase1_tol = max(self.phase1_tol, 1e-4)
        if self.pricing not in ("dantzig", "steepest", "first", "first_memory"):
            raise ValueError(f"unsupported pricing rule {self.pricing!r}")
        if self.chunk_size > self.refactor_period and not self.device_refactor:
            self.chunk_size = self.refactor_period


_DEFAULT: Optional[SolverConfig] = None


def default_config() -> SolverConfig:
    """The process-wide default configuration."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = SolverConfig(
            dtype=os.environ.get("RELP_TPU_DTYPE", "float32"),
        )
    return _DEFAULT


def torch_device(cfg: SolverConfig) -> torch.device:
    """The device a solve runs on; raises when CUDA is asked for and absent.

    On CUDA this also turns TF32 off for matmuls (``allow_tf32 = False``,
    float32 matmul precision "highest"), process-wide: the state-carrying
    products (FTRAN, rank-1 updates, Newton-Schulz, residuals) must be true
    f32, as the JAX package runs them at HIGHEST.  TF32 keeps a 10-bit
    mantissa, the analog of the TPU's single-pass bf16.
    """
    name = cfg.platform or "cuda"
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "SolverConfig.platform is CUDA but torch.cuda.is_available() "
                "is False; pass platform='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif device.type != "cpu":
        raise ValueError(f"unsupported platform {cfg.platform!r}")
    return device
