"""Calibrated configuration registry (port of ``configs.py``).

The Horn-Schunck h-parameter table and ``hs_alphas`` are copies of the JAX
package's; all of its configurations are registered with the same fields:
five HS, four Liu-Shen, five dense-LK and five Farneback ones.

Use ``run_config(name, im1, im2)`` or ``build_config(name)`` for the pieces.
The three configurations whose main adapter is the calibrated Horn-Schunck
one (``HS_CALIBRATED``) also run on any other row of ``HS_H_TABLE`` by a
calibrated name ``"<config>@<bits>/<ni>"``, e.g.
``"LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits12/Ni06"`` for 12-bit frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

from opticalflow_ri_tpu_torch.models.farneback import FarnebackAdapter
from opticalflow_ri_tpu_torch.models.horn_schunck import HSOpticalFlowAlgoAdapter
from opticalflow_ri_tpu_torch.models.liu_shen import LiuShenOpticalFlowAlgoAdapter
from opticalflow_ri_tpu_torch.models.lucas_kanade import DenseLucasKanadeAdapter
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


def _hs(levels, niter=600, bits="Bits08", ni="Ni06"):
    return lambda: HSOpticalFlowAlgoAdapter(hs_alphas(levels, 1, bits, ni), niter)


CONFIGS = {}


def _register(cfg: FlowConfig):
    CONFIGS[cfg.name] = cfg
    return cfg


# --- example scripts -------------------------------------------------------
_register(FlowConfig("PyHSchunck_Fs3_4", _hs(1), filter_sigma=3.4, pyr_levels=1))
_register(FlowConfig("PyHSchunck_Fs3_4_PyrLvls2", _hs(2), filter_sigma=3.4, pyr_levels=2))
_register(FlowConfig(
    "LiuSE_PyHSchunck_Fs3_4_PyrLvls2", _hs(2), filter_sigma=3.4, pyr_levels=2,
    filter_opt=0.48, optional=lambda: LiuShenOpticalFlowAlgoAdapter(5),
))
_register(FlowConfig(
    "denseLK_Fs2_0", lambda: DenseLucasKanadeAdapter(Niter=5, halfWindow=13),
    filter_sigma=2.0, pyr_levels=1, filter_opt=0.48, kwargs={"warping": False},
))
_register(FlowConfig(
    "denseLK_Fs2_0_PyrLvls2", lambda: DenseLucasKanadeAdapter(Niter=5, halfWindow=13),
    filter_sigma=2.0, pyr_levels=2, filter_opt=0.48, kwargs={"warping": False},
))
_register(FlowConfig(
    "LiuSE_denseLK_Fs2_0_PyrLvls2", lambda: DenseLucasKanadeAdapter(Niter=5, halfWindow=13),
    filter_sigma=2.0, pyr_levels=2, filter_opt=0.48,
    optional=lambda: LiuShenOpticalFlowAlgoAdapter(10), kwargs={"warping": False},
))
_register(FlowConfig(
    "Farneback_Fs0_0", lambda: FarnebackAdapter(), filter_sigma=0.0,
    pyr_levels=1, filter_opt=0.48,
))
_register(FlowConfig(
    "Farneback_Fs0_0_PyrLvls2", lambda: FarnebackAdapter(), filter_sigma=0.0,
    pyr_levels=2,
))
_register(FlowConfig(
    "LiuSE_Farneback_Fs0_0_PyrLvls2", lambda: FarnebackAdapter(), filter_sigma=0.0,
    pyr_levels=2, filter_opt=0.48, optional=lambda: LiuShenOpticalFlowAlgoAdapter(10),
))

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
_register(FlowConfig(
    "LiuSE_HS_Fs3_4_PyrLvls2", lambda: LiuShenOpticalFlowAlgoAdapter(0.1),
    filter_sigma=3.4, pyr_levels=2,
))
_register(FlowConfig(
    "LK_Fs2_0", lambda: DenseLucasKanadeAdapter(halfWindow=13, Niter=5),
    filter_sigma=2.0,
))
_register(FlowConfig(
    "LK_Fs2_0_PyrLvls2", lambda: DenseLucasKanadeAdapter(halfWindow=13, Niter=5),
    filter_sigma=2.0, pyr_levels=2,
))
# Benchmark-harness composition quirk: with use_liu_shen the LiuShen(0.1)
# adapter *replaces* the main adapter (the LK/FB adapter is constructed but
# never used), keeping that config's filter_sigma / pyr_levels
# (JAX configs.py:148-151).
_register(FlowConfig(
    "LiuSE_LK_Fs2_0_PyrLvls2", lambda: LiuShenOpticalFlowAlgoAdapter(0.1),
    filter_sigma=2.0, pyr_levels=2,
))
_register(FlowConfig(
    "FB_Fs0_0", lambda: FarnebackAdapter(windowSize=33, Niters=5, polyN=7, polySigma=1.5),
))
_register(FlowConfig(
    "FB_Fs0_0_PyrLvls2", lambda: FarnebackAdapter(windowSize=33, Niters=5, polyN=7, polySigma=1.5),
    pyr_levels=2,
))
_register(FlowConfig(
    "LiuSE_FB_Fs0_0_PyrLvls2", lambda: LiuShenOpticalFlowAlgoAdapter(0.1),
    filter_sigma=0.0, pyr_levels=2,
))

# JAX-package configurations not ported yet: none, every one is registered above
UNPORTED: dict[str, str] = {}

# the configurations built on ``_hs``: their HS alphas come from a row of
# HS_H_TABLE (Bits08/Ni06 under the plain name), at 600 iterations a level
HS_CALIBRATED = ("PyHSchunck_Fs3_4", "PyHSchunck_Fs3_4_PyrLvls2",
                 "LiuSE_PyHSchunck_Fs3_4_PyrLvls2")


def base_name(name: str) -> str:
    """The registered configuration a name runs: ``name`` without its
    calibration (``"PyHSchunck_Fs3_4@Bits12/Ni06"`` -> ``"PyHSchunck_Fs3_4"``)."""
    return name.partition("@")[0]


def build_config(name: str) -> FlowConfig:
    """The configuration ``name``: a key of ``CONFIGS``, or a calibrated name
    ``"<config>@<bits>/<ni>"``, the ``HS_CALIBRATED`` config ``<config>``
    with its alphas ``hs_alphas(levels, 1, bits, ni)`` (the upstream's
    scripts at another bit depth or seeding)."""
    if name in CONFIGS:
        return CONFIGS[name]
    base, at, row = name.partition("@")
    if not at:
        raise KeyError(f"unknown config {name!r}")
    if base not in HS_CALIBRATED:
        raise KeyError(f"unknown config {name!r}: a calibrated name runs one of "
                       f"{', '.join(HS_CALIBRATED)}")
    bits, _, ni = row.partition("/")
    if (bits, ni) not in HS_H_TABLE:
        rows = ", ".join(f"{b}/{n}" for b, n in HS_H_TABLE)
        raise KeyError(f"unknown config {name!r}: no h-table row {row!r}; the rows are {rows}")
    cfg = CONFIGS[base]
    return replace(cfg, name=name, main=_hs(cfg.pyr_levels, bits=bits, ni=ni))


def run_config(name: str, im1, im2, device="cuda"):
    """Run a named calibrated configuration; returns (U, V).  Numpy inputs go
    to ``device``; tensors stay where they are."""
    return build_config(name).run(im1, im2, device=device)
