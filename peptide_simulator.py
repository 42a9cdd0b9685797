"""Compatibility shim: the reference's ``peptide_simulator`` module
(/root/reference/peptide_simulator.py), backed by the batched device sim
layer."""

from fluorosequencingimageanalysis_tpu.sim.events import (  # noqa
    FluorEvent, _define_reserved_character, _make_mock, _make_edman,
    _make_tirf, _make_dud, _increment_cycle, _make_count_dyes,
    _make_strip_surface, _make_get_dye_positions, simulate_dye_counts,
    simulate_photometries, peptide_simulation, convert_to_oldstyle)
from fluorosequencingimageanalysis_tpu.sim.dye_sim import (  # noqa
    simulate_dye_counts_batched, simulate_photometries_batched)
