"""Compatibility shim: the ``mpfit`` import surface
(/root/reference/agpy/mpfit/mpfit.py — reached via agpy's path insertion,
pflib.py:22-23 / gaussfitter.py imports). The class lives in
fluorosequencingimageanalysis_tpu.mpfit_compat; the pipeline's hot PSF-fit
path uses the batched device LM (ops/lm.py) instead.
"""

from fluorosequencingimageanalysis_tpu.mpfit_compat import mpfit  # noqa
