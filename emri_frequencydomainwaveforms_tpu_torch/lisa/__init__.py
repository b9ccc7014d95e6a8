"""LISA layer: sensitivity curves, the legacy MLDC noise models, the TDI
container, noise, inner products, the Fisher / Cramer-Rao diagnostics, the
whitened likelihood and relative binning."""

from .diagnostic import (
    covariance,
    cutler_vallisneri_bias,
    fisher,
    get_eigens,
    get_mismatch,
    inner_product,
    overlap,
    scale_snr,
    snr,
    vallisneri_criterion,
    vallisneri_criterion_cdf,
)
from .likelihood import Likelihood
from .mldc import (
    MLDCModel,
    PhinneyBackground,
    galconf,
    make_wd_noise,
    mldc_lisanoise,
    mldc_lisanoises,
    mldc_model,
    mldc_noisepsd_AE,
    mldc_noisepsd_T,
    mldc_noisepsd_X,
    mldc_simplesnr,
    sgal,
    simplesnr,
)
from .noise import generate_noise_fd
from .relbin import RelativeBinningLikelihood
from .sensitivity import (
    AET,
    cornish_lisa_psd,
    get_sensitivity,
    lisasens,
    noisepsd_AE,
    noisepsd_AE2,
    noisepsd_T,
    noisepsd_X,
    noisepsd_X2,
    sensitivity_from_table,
)
from .tdi import TDIf

__all__ = [
    "inner_product",
    "overlap",
    "snr",
    "fisher",
    "covariance",
    "get_mismatch",
    "cutler_vallisneri_bias",
    "get_eigens",
    "vallisneri_criterion",
    "vallisneri_criterion_cdf",
    "scale_snr",
    "Likelihood",
    "RelativeBinningLikelihood",
    "generate_noise_fd",
    "get_sensitivity",
    "cornish_lisa_psd",
    "lisasens",
    "noisepsd_X",
    "noisepsd_X2",
    "noisepsd_AE",
    "noisepsd_AE2",
    "noisepsd_T",
    "AET",
    "TDIf",
    "MLDCModel",
    "PhinneyBackground",
    "mldc_model",
    "mldc_lisanoises",
    "mldc_lisanoise",
    "mldc_noisepsd_X",
    "mldc_noisepsd_AE",
    "mldc_noisepsd_T",
    "mldc_simplesnr",
    "simplesnr",
    "sgal",
    "galconf",
    "make_wd_noise",
    "sensitivity_from_table",
]
