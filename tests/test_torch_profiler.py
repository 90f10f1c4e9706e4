"""The port's device profiler (mmlspark_tpu_torch.observability.profiler)
against the JAX package's: the same note_* calls render the reference's
registry text and publish its events; roofline rows equal the reference's
for the same peaks. Then what the port adds: the card's peak table,
caller-supplied costs, and a fit that stays quiet (no event, no sync) until
the profiler is enabled, and then books ``gbdt.step`` and names the step's
regions in a trace.

Reference modules are imported inside fixtures (the card machine imports
this file without jax).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_gbdt import _import_reference

# At import, so that every pytest worker has the JAX package's fit path
# before it collects the JAX package's own test files (see
# tests/test_torch_gbdt.py); the card machine has no jax.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch.core import profiling as tprofiling
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import profiler as tprofiler
from mmlspark_tpu_torch.observability import registry as tregistry
from mmlspark_tpu_torch.ops import hopper_histogram as hh

TIMING = {"t", "wt"}


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability import profiler as jprofiler
    from mmlspark_tpu.observability import registry as jregistry

    return dict(events=jevents, profiler=jprofiler, registry=jregistry)


@pytest.fixture
def quiet_profiler(monkeypatch):
    """The process-global profiler, disabled and empty before and after."""
    monkeypatch.delenv("MMLSPARK_TPU_PROFILE", raising=False)
    prof = tprofiler.get_profiler()
    prof.disable()
    prof.clear()
    yield prof
    prof.disable()
    prof.clear()


def _note_calls(profiler_mod, registry_mod, events_mod):
    """One script of note_* calls on an isolated profiler; returns the
    registry text, the published records, and the profile table."""
    reg = registry_mod.MetricsRegistry()
    bus = events_mod.EventBus()
    seen = []
    bus.add_listener(seen.append)
    prof = profiler_mod.DeviceProfiler(registry=reg, bus=bus)
    prof.note_compile("gbdt.step", 0.75, flops=1e9, bytes_accessed=4e8, signature="f32(8,)")
    for s in (0.01, 0.02, 0.5):
        prof.note_execute("gbdt.step", s)
    prof.note_cache_hit("gbdt.step")
    prof.note_cache_hit("gbdt.step")
    prof.note_compile("hist", 2.0)
    prof.note_execute("hist", 0.003)
    prof.note_transfer(4096, "h2d", name="hist")
    prof.note_transfer(0)
    prof.note_transfer(512, "d2h")
    prof.merge("allreduce", executions=3, device_seconds=0.25, compiles=1, compile_seconds=0.5)
    prof.note_program_cache(hit=False, size=1)
    prof.note_program_cache(hit=True, size=1)
    prof.disable()
    prof.note_execute("after-disable", 0.1)  # note_* calls book whatever the switch says
    records = [{k: v for k, v in e.to_record().items() if k not in TIMING} for e in seen]
    table = {name: p.to_dict() for name, p in sorted(prof._profiles.items())}
    return reg.exposition(), records, table


def test_note_calls_render_the_references_registry_and_events(ref):
    port = _note_calls(tprofiler, tregistry, tevents)
    refr = _note_calls(ref["profiler"], ref["registry"], ref["events"])
    assert port == refr
    text, records, table = port
    assert 'profiler_compiles_total{fn="gbdt.step"} 1' in text
    assert [r["event"] for r in records][:2] == ["ProfileCompiled", "ProfileExecuted"]
    assert table["hist"]["transfer_bytes"] == 4096.0


PROFILES = [
    dict(),
    dict(executions=4, device_seconds=0.02, flops=3e9, bytes_accessed=8e8),
    dict(executions=1, device_seconds=1e-3, flops=1e12, bytes_accessed=1e6),
    dict(executions=2, device_seconds=0.0, flops=5.0, bytes_accessed=0.0),
    dict(executions=7, device_seconds=0.3, bytes_accessed=2e9),
]
PEAKS = [(0.0, 0.0, None), (67e12, 3.35e12, "h100"), (1.97e14, 8.1e11, "v5e"),
         (0.0, 0.0, "unknown-platform"), (0.0, 0.0, "env-override"), (2e13, 0.0, "x")]


@pytest.mark.parametrize("peaks", PEAKS, ids=lambda p: str(p[2]))
@pytest.mark.parametrize("fields", PROFILES, ids=range(len(PROFILES)))
def test_roofline_equals_the_references(ref, fields, peaks):
    port = tprofiler.FunctionProfile("f", **fields).roofline(*peaks[:2], platform=peaks[2])
    jref = ref["profiler"].FunctionProfile("f", **fields).roofline(*peaks[:2], platform=peaks[2])
    assert port == jref
    assert [f.name for f in dataclasses.fields(tprofiler.FunctionProfile)] == \
        [f.name for f in dataclasses.fields(ref["profiler"].FunctionProfile)]


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (67e12, 3.35e12, "h100")),
    ("NVIDIA H100 PCIe", (51e12, 2.0e12, "h100 pcie")),
    ("NVIDIA H100 NVL", (60e12, 3.9e12, "h100 nvl")),
    ("NVIDIA H200", (67e12, 4.8e12, "h200")),
    ("Tesla T4", (0.0, 0.0, tprofiler.UNKNOWN_PLATFORM)),
    ("TPU v5 lite", (0.0, 0.0, tprofiler.UNKNOWN_PLATFORM)),
])
def test_device_peaks_hold_the_hopper_cards_only(name, want, monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MMLSPARK_TPU_PEAK_HBM_BYTES", raising=False)
    peaks = tprofiler.device_peaks(name)
    assert (peaks[0], peaks[1], peaks.platform) == want
    assert peaks.known == (want[2] != tprofiler.UNKNOWN_PLATFORM)


def test_peak_overrides_and_the_bound():
    h100 = tprofiler.DevicePeaks(67e12, 3.35e12, "h100")
    assert h100.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert h100.bound_ms(1.0, 67e9) == (1.0, "operations")
    ms, by = h100.bound_ms(*[hh.bytes_needed(11_000_000, 28, 11_000_000, 8, 256),
                             hh.adds_needed(28, 11_000_000)])
    assert by == "bytes" and ms == pytest.approx(484_688_128 / 3.35e9)
    env = dict(os.environ, MMLSPARK_TPU_PEAK_FLOPS="1e12", MMLSPARK_TPU_PEAK_HBM_BYTES="2e11")
    code = ("from mmlspark_tpu_torch.observability.profiler import device_peaks\n"
            "p = device_peaks('NVIDIA H100 80GB HBM3')\n"
            "print(p[0], p[1], p.platform)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert out == ["1000000000000.0", "200000000000.0", "env-override"]


def test_wrap_books_first_calls_and_the_callers_cost():
    reg = tregistry.MetricsRegistry()
    bus = tevents.EventBus()
    seen = []
    bus.add_listener(seen.append)
    prof = tprofiler.DeviceProfiler(registry=reg, bus=bus)
    rng = np.random.default_rng(3)
    n, f, b = 4000, 5, 64
    bins_t = torch.from_numpy(rng.integers(0, b, size=(f, n), dtype=np.uint8))
    g, h = torch.randn(n), torch.rand(n)
    c = torch.ones(n)
    node = torch.from_numpy(rng.integers(0, 4, size=n).astype(np.int32))
    wrapped = prof.wrap(hh.build_histograms_cuda, name="hist", cost=hh.histogram_cost)
    out = wrapped(bins_t, g, h, c, node, 3, b)
    assert torch.equal(out, hh.build_histograms_plain(bins_t, g, h, c, node, 3, b))
    wrapped(bins_t, g, h, c, node, 3, b)
    wrapped(bins_t[:, :100].contiguous(), g[:100], h[:100], c[:100], node[:100], 3, b)  # new
    p = prof._profiles["hist"]
    assert (p.compiles, p.cache_hits, p.executions) == (2, 1, 3)
    n_in = int((node[:100] < 3).sum())  # the cost of the last first call
    assert p.flops == hh.adds_needed(f, n_in)
    assert p.bytes_accessed == hh.bytes_needed(100, f, n_in, 3, b)
    compiled = [e for e in seen if isinstance(e, tevents.ProfileCompiled)]
    assert [e.signature for e in compiled] == [
        f"torch.uint8({f}, {n}),torch.float32({n},),torch.float32({n},),torch.float32({n},),"
        f"torch.int32({n},),int,int",
        "torch.uint8(5, 100),torch.float32(100,),torch.float32(100,),torch.float32(100,),"
        "torch.int32(100,),int,int"]
    prof.disable()
    assert prof.wrap(len) is len
    wrapped(bins_t, g, h, c, node, 3, b)  # a wrapped call made while off is not booked
    assert p.executions == 3


def test_cpu_snapshot_and_memory_sample():
    prof = tprofiler.DeviceProfiler(registry=tregistry.MetricsRegistry(), bus=tevents.EventBus())
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert prof.sample_memory() == {}
    snap = prof.snapshot()
    assert snap["device"] == {"backend": "cpu", "kind": "", "count": 0}
    assert snap["memory"] == {} and snap["roofline"] == []


def test_get_profiler_follows_the_environment(monkeypatch, quiet_profiler):
    assert not tprofiler.get_profiler().active
    monkeypatch.setenv("MMLSPARK_TPU_PROFILE", "1")
    assert tprofiler.get_profiler().active
    monkeypatch.setenv("MMLSPARK_TPU_PROFILE", "off")
    assert not tprofiler.get_profiler().active
    assert tprofiler.get_profiler() is quiet_profiler


def _small_fit():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3000, 6))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=3000) > 0).astype(np.float64)
    bins, mapper = tbinning.bin_dataset(X, max_bin=63)
    opts = ttrain.TrainOptions(objective="binary", num_iterations=4, num_leaves=15,
                               min_gain_to_split=1e-3)
    return lambda: ttrain.train(bins, y, opts, mapper=mapper, device="cpu")


def test_a_quiet_fit_publishes_nothing_and_adds_no_sync(monkeypatch, quiet_profiler):
    fit = _small_fit()
    syncs = {"torch": 0, "profiler": 0}

    def count(key, fn):
        def counted(*a, **kw):
            syncs[key] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(torch.cuda, "synchronize", count("torch", torch.cuda.synchronize))
    monkeypatch.setattr(tprofiler, "_sync", count("profiler", tprofiler._sync))
    bus = tevents.get_bus()
    seen = []
    bus.add_listener(seen.append)
    try:
        quiet = fit()
        quiet_events = [type(e).__name__ for e in seen]
        assert syncs == {"torch": 0, "profiler": 0}
        assert not any(n.startswith("Profile") for n in quiet_events)
        assert quiet_profiler._profiles == {}
        seen.clear()
        quiet_profiler.enable()
        loud = fit()
    finally:
        bus.remove_listener(seen.append)
    assert loud.booster.model_to_string() == quiet.booster.model_to_string()
    assert syncs == {"torch": 0, "profiler": 0}  # the step is timed on the fit's own sync
    names = [type(e).__name__ for e in seen if type(e).__name__.startswith("Profile")]
    assert names == ["ProfileCompiled"] + ["ProfileExecuted"] * 4
    p = quiet_profiler._profiles["gbdt.step"]
    assert (p.compiles, p.cache_hits, p.executions) == (1, 3, 4)
    compiled = next(e for e in seen if isinstance(e, tevents.ProfileCompiled))
    assert compiled.name == "gbdt.step" and compiled.signature.startswith("torch.uint8(6, 3000)")


def test_a_profiled_fit_names_the_steps_regions_in_a_trace(tmp_path, quiet_profiler):
    fit = _small_fit()
    quiet_profiler.enable()
    with tprofiling.profile_trace(str(tmp_path)) as prof:
        fit()
    names = {e.key: e.count for e in prof.key_averages()}
    assert names["gbdt.step"] == 4
    for region in ("gbdt.gradient", "gbdt.histogram", "gbdt.split_search", "gbdt.sync",
                   "gbdt.routing", "gbdt.subtraction", "gbdt.tree_update",
                   "gbdt.margin_update"):
        assert names.get(region, 0) > 0, region
    assert len(os.listdir(tmp_path)) == 1


def test_observability_imports_neither_jax_nor_the_reference():
    code = ("import sys, mmlspark_tpu_torch.observability, mmlspark_tpu_torch.dataguard\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
