"""Per-backend dispatch constants and in-process link probes
(utils/probes)."""

import subprocess

import pytest

from fluorosequencingimageanalysis_tpu.utils import probes


def test_snapshot_structure_and_caching(monkeypatch):
    """snapshot() returns every link value and decision; link values are
    measured once per process and served from the session memo after."""
    probes._SESSION.clear()
    snap = probes.snapshot()
    for key in ("link_bandwidth_MBps", "fetch_bandwidth_MBps",
                "link_latency_ms", "stepfit_chunk", "v8_chunk",
                "detect_chunk", "chisq_engine", "timetrace_prefetch"):
        assert key in snap, key
    assert snap["link_bandwidth_MBps"] > 0
    monkeypatch.setattr(probes.time, "perf_counter",
                        lambda: (_ for _ in ()).throw(AssertionError))
    assert probes.link_bandwidth_MBps() == pytest.approx(
        snap["link_bandwidth_MBps"], abs=0.05)


def test_cpu_backend_keeps_safe_chunks():
    """The CPU (the test platform) keeps the small chunks."""
    assert probes.stepfit_chunk() == 2048
    assert probes.v8_chunk() == 32768
    assert probes.detect_chunk() == 2048
    assert probes.chisq_engine() == "native"


@pytest.mark.parametrize("on_cpu, expected", [
    (True, (2048, 32768, 2048, "native")),
    # Measured on an H100 (PERF.md, bring-up findings).
    (False, (8192, 65536, 4096, "native")),
])
def test_dispatch_constants_per_backend(monkeypatch, on_cpu, expected):
    monkeypatch.setattr(probes, "_is_cpu", lambda: on_cpu)
    got = (probes.stepfit_chunk(), probes.v8_chunk(),
           probes.detect_chunk(), probes.chisq_engine())
    assert got == expected
    # Chunked programs pad ragged tails to power-of-two buckets, so every
    # cap must itself be a power of two.
    for chunk in got[:3]:
        assert chunk & (chunk - 1) == 0


def test_registry_starts_no_process(monkeypatch):
    """No decision spawns a child process: a child JAX process could not
    open a card its parent holds."""
    monkeypatch.setattr(probes, "_is_cpu", lambda: False)
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: pytest.fail("spawned a process"))
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: pytest.fail("spawned a process"))
    probes.stepfit_chunk(), probes.v8_chunk(), probes.detect_chunk()
    probes.chisq_engine()
    assert not hasattr(probes, "subprocess")


def test_probes_off_mode(monkeypatch):
    monkeypatch.setenv("FSIA_PROBES", "off")
    assert probes.stepfit_chunk() == 2048
    assert probes.v8_chunk() == 32768
    assert probes.timetrace_prefetch() is False


def test_decision_thresholds(monkeypatch):
    """Prefetch decision against synthetic link values (no device work)."""
    monkeypatch.setattr(probes, "_is_cpu", lambda: False)
    monkeypatch.setattr(probes, "link_bandwidth_MBps", lambda: 900.0)
    assert probes.timetrace_prefetch() is True
    monkeypatch.setattr(probes, "link_bandwidth_MBps", lambda: 70.0)
    assert probes.timetrace_prefetch() is False


def test_link_probes_are_session_scoped():
    """Link bandwidth/latency are SESSION properties: measured once per
    process and dropped by refresh_session()."""
    probes._SESSION.clear()
    probes._SESSION["link_bandwidth_MBps"] = 42.0
    assert probes.link_bandwidth_MBps() == 42.0
    probes.refresh_session()
    assert "link_bandwidth_MBps" not in probes._SESSION


def test_upload_group_items_sizing(monkeypatch):
    """Group sizing from the session link: groups grow until per-group
    upload time dominates latency, capped to keep 2 groups in flight,
    rounded to a mesh multiple; off-mode/CPU keep the static default."""
    monkeypatch.setattr(probes, "_is_cpu", lambda: False)
    monkeypatch.setattr(probes, "link_latency_s", lambda: 0.05)
    monkeypatch.setattr(probes, "link_bandwidth_MBps", lambda: 60.0)
    # 0.5 MB frames (the zstack shape): 4*0.05*60/0.5 = 24 frames.
    assert probes.upload_group_items(0.5, 1, 64) == 24
    # Mesh multiple rounding.
    assert probes.upload_group_items(0.5, 8, 64) % 8 == 0
    # 2-in-flight cap: a 32-frame stack caps at ceil(32/2)=16.
    assert probes.upload_group_items(0.5, 1, 32) == 16
    # 4 MB fields (config 4): 4*0.05*60/4 = 3 -> floor 8 wins.
    assert probes.upload_group_items(4.0, 1, 32) == 8
    # Tiny latency: floor wins.
    monkeypatch.setattr(probes, "link_latency_s", lambda: 1e-5)
    assert probes.upload_group_items(0.5, 1, 64) == 8
    # off-mode: static default, no link measurement.
    monkeypatch.setenv("FSIA_PROBES", "off")
    monkeypatch.setattr(probes, "link_latency_s",
                        lambda: (_ for _ in ()).throw(AssertionError))
    assert probes.upload_group_items(0.5, 4, 64) == 8


def test_upload_group_items_capped_at_workload(monkeypatch):
    """The latency-derived group size must never exceed the workload
    itself: a tiny stack on a high-latency link would otherwise pad to a
    giant repeated-frame group, multiplying upload bytes and compiling a
    one-off inflated shape."""
    monkeypatch.setattr(probes, "_is_cpu", lambda: False)
    monkeypatch.setattr(probes, "link_latency_s", lambda: 0.05)
    monkeypatch.setattr(probes, "link_bandwidth_MBps", lambda: 60.0)
    # 0.016 MB frames: unbounded g would be 750.
    assert probes.upload_group_items(0.016, 1, 12) == 12
    assert probes.upload_group_items(0.016, 8, 12) == 16  # mesh multiple
    assert probes.upload_group_items(0.016, 1, 1) == 1
