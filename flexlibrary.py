"""Compatibility shim: the reference's ``flexlibrary`` module
(/root/reference/flexlibrary.py), backed by the batched device pipeline
layer."""

from fluorosequencingimageanalysis_tpu.pipeline import (  # noqa
    Spot, Image, Trace, SimpleTrace, PhotometryTrace, PlateauTrace,
    Experiment, SequenceExperiment, MultichannelSequenceExperiment,
    MultifieldMultichannelSequenceExperiment, TimetraceExperiment)
from fluorosequencingimageanalysis_tpu.pipeline.experiment import (  # noqa
    MultifieldSequenceExperiment)
