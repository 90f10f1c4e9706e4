"""The CPU dry run of ``chip_smoke.py``'s phase 32 (TrainClassifier and
TrainRegressor), split off ``tests/test_torch_trainers.py`` so the test
workers can run it beside that file's parity cases.
"""

import torch

from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.train import TrainClassifier, TrainRegressor

from _torch_trainers_cases import _TorchProxy


def test_chip_smoke_trainers_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """A dry run of ``chip_smoke.phase_trainers`` at 2,000 rows and 2
    iterations through a torch proxy, the entry points' device patched to
    the CPU and the kernel entries counting their plain calls as launches:
    catches name errors and broken checks before a chip call."""
    import chip_smoke
    from mmlspark_tpu_torch import featurize
    from mmlspark_tpu_torch.lightgbm import base as tbase
    from mmlspark_tpu_torch.lightgbm import booster as tbooster
    from mmlspark_tpu_torch.lightgbm import objectives as tobjectives
    from mmlspark_tpu_torch.lightgbm import train as ttrain
    from mmlspark_tpu_torch.observability import profiler as tprofiler
    from mmlspark_tpu_torch.ops import histogram as thistogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh

    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    for module in (ttrain, tbase, tbooster):
        monkeypatch.setattr(module, "resolve_device", cpu)
    for name in ("build_histograms_cuda", "build_histograms_combined_cuda"):
        fn = getattr(thistogram, name)

        def counted(*a, _fn=fn, _entry=getattr(hh, name)):
            out = _fn(*a)
            hh.count_launch(_entry)
            return out

        monkeypatch.setattr(thistogram, name, counted)
    monkeypatch.setattr(chip_smoke, "DATA_DIR", str(tmp_path))
    for name, value in (("N_TRAINERS", 2000), ("N_TEST", 1000), ("N_TRAINERS_CPU", 200),
                        ("N_TRAINERS_REG", 500), ("N_TRAINERS_REG_TEST", 200)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setitem(chip_smoke.TRAINERS_PARAMS, "numIterations", 2)
    rec = chip_smoke.phase_trainers(
        _TorchProxy(), uh, hh, tprofiler.device_peaks("NVIDIA H100 80GB HBM3"), tbase,
        tobjectives, ttrain, featurize, Table, PipelineStage, LightGBMClassifier,
        LightGBMRegressor, TrainClassifier, TrainRegressor, tobjectives.auc,
        "NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["fit"]["plans"] == chip_smoke.TRAINERS_PLAN
    assert rec["fit"]["columns"] == 590 and rec["card_cpu"]["text_equal"]
    assert all(rec["save_load"]["columns_equal"].values())
    assert set(rec["kernels"]) == {1, 8} and rec["launches"]["hist_panel"] > 0
    assert all(r["max_abs_err"] == 0.0 for r in rec["kernels"].values())
