"""Calibrated configuration registry (port of ``configs.py``, HS entries).

The Horn-Schunck h-parameter table and ``hs_alphas`` are copies of the JAX
package's; the five HS configurations are registered with the same fields.
The other registered names of the JAX package raise ``KeyError`` naming the
ROADMAP slice that brings them.

Use ``run_config(name, im1, im2)`` or ``build_config(name)`` for the pieces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from opticalflow_ri_tpu_torch.models.horn_schunck import HSOpticalFlowAlgoAdapter
from opticalflow_ri_tpu_torch.pyramid import generic_pyramidal_optical_flow

# Horn-Schunck h-parameter calibration table: (bits, ni) -> (h at level 1,
# h at levels > 1).  Prefers ~3.0 px diameter particles.
HS_H_TABLE = {
    ("Bits08", "Ni01"): (6, 40),
    ("Bits08", "Ni06"): (21, 45),
    ("Bits08", "Ni12"): (30, 61),
    ("Bits08", "Ni16"): (34, 75),
    ("Bits10", "Ni01"): (20, 450),
    ("Bits10", "Ni06"): (77, 450),
    ("Bits10", "Ni12"): (119, 450),
    ("Bits10", "Ni16"): (131, 500),
    ("Bits12", "Ni01"): (82, 500),
    ("Bits12", "Ni06"): (325, 920),
    ("Bits12", "Ni12"): (470, 1260),
    ("Bits12", "Ni16"): (550, 1460),
}


def hs_alphas(pyramidal_levels: int, k_levels: int = 1, bits: str = "Bits08",
              ni: str = "Ni06") -> list:
    """Alpha list exactly as the example scripts build it: one entry per
    (level, k) in level order; the adapter pops from the END, so the coarsest
    level consumes the last entry."""
    h1, hn = HS_H_TABLE[(bits, ni)]
    alphas = []
    for level in range(1, pyramidal_levels + 1):
        h = h1 if level == 1 else hn
        alphas.extend([h] * k_levels)
    return alphas


@dataclass
class FlowConfig:
    name: str
    main: Callable[[], object]
    filter_sigma: float = 0.0
    pyr_levels: int = 1
    k_levels: int = 1
    filter_opt: Optional[float] = None
    optional: Optional[Callable[[], object]] = None
    kwargs: dict = field(default_factory=dict)

    def run(self, im1, im2, device="cuda"):
        """Fresh adapters per run, so stateful alpha lists start full."""
        main = self.main()
        opt = self.optional() if self.optional is not None else None
        return generic_pyramidal_optical_flow(
            im1, im2, self.filter_sigma, main,
            pyramidalLevels=self.pyr_levels, kLevels=self.k_levels,
            FILTER_OPT=self.filter_opt, optionalOFlowAlgoAdapter=opt,
            device=device, **self.kwargs,
        )


def _hs(levels, niter=600):
    return lambda: HSOpticalFlowAlgoAdapter(hs_alphas(levels), niter)


CONFIGS = {}


def _register(cfg: FlowConfig):
    CONFIGS[cfg.name] = cfg
    return cfg


# --- example scripts -------------------------------------------------------
_register(FlowConfig("PyHSchunck_Fs3_4", _hs(1), filter_sigma=3.4, pyr_levels=1))
_register(FlowConfig("PyHSchunck_Fs3_4_PyrLvls2", _hs(2), filter_sigma=3.4, pyr_levels=2))

# --- benchmark harness configs ---------------------------------------------
_register(FlowConfig(
    "HS_Fs0_0", lambda: HSOpticalFlowAlgoAdapter([1.0], 100), filter_sigma=0.0,
))
_register(FlowConfig(
    "HS_Fs3_4", lambda: HSOpticalFlowAlgoAdapter([1.0], 100), filter_sigma=3.4,
))
_register(FlowConfig(
    "HS_Fs3_4_PyrLvls2", lambda: HSOpticalFlowAlgoAdapter([1.0, 1.0], 100),
    filter_sigma=3.4, pyr_levels=2,
))

_LIU_SHEN = "the Liu-Shen slice (ROADMAP.md Queue 1, item 4)"
_DENSE_LK = "the dense Lucas-Kanade slice (ROADMAP.md Queue 1, item 5)"
_FARNEBACK = "the Farneback slice (ROADMAP.md Queue 1, item 6)"

# JAX-package configurations not ported yet, with the slice that brings each
UNPORTED = {
    "LiuSE_PyHSchunck_Fs3_4_PyrLvls2": _LIU_SHEN,
    "LiuSE_HS_Fs3_4_PyrLvls2": _LIU_SHEN,
    "LiuSE_LK_Fs2_0_PyrLvls2": _LIU_SHEN,
    "LiuSE_FB_Fs0_0_PyrLvls2": _LIU_SHEN,
    "denseLK_Fs2_0": _DENSE_LK,
    "denseLK_Fs2_0_PyrLvls2": _DENSE_LK,
    "LK_Fs2_0": _DENSE_LK,
    "LK_Fs2_0_PyrLvls2": _DENSE_LK,
    "LiuSE_denseLK_Fs2_0_PyrLvls2": f"{_DENSE_LK} and {_LIU_SHEN}",
    "Farneback_Fs0_0": _FARNEBACK,
    "Farneback_Fs0_0_PyrLvls2": _FARNEBACK,
    "FB_Fs0_0": _FARNEBACK,
    "FB_Fs0_0_PyrLvls2": _FARNEBACK,
    "LiuSE_Farneback_Fs0_0_PyrLvls2": f"{_FARNEBACK} and {_LIU_SHEN}",
}


def build_config(name: str) -> FlowConfig:
    if name in CONFIGS:
        return CONFIGS[name]
    if name in UNPORTED:
        raise KeyError(f"config {name!r} is not ported to PyTorch yet; it comes with "
                       f"{UNPORTED[name]}")
    raise KeyError(f"unknown config {name!r}")


def run_config(name: str, im1, im2, device="cuda"):
    """Run a named calibrated configuration; returns (U, V).  Numpy inputs go
    to ``device``; tensors stay where they are."""
    return build_config(name).run(im1, im2, device=device)
